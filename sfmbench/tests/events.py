"""Hand-made kineto events and a profile that hands them over, for the
trace readers' tests."""

from __future__ import annotations


class Event:
    """One kineto event: on the device or the host, its name, start and end
    (ns), thread, correlation id, the correlation id of the op or record it
    was launched from (device work), and whether it is a user annotation."""

    def __init__(self, dev, name, s, e, th=1, corr=0, linked=0, ua=False):
        self._v = (dev, name, s, e, th, corr, ua, linked)

    def device_type(self):
        return "DeviceType.CUDA" if self._v[0] else "DeviceType.CPU"

    def name(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]

    def linked_correlation_id(self):
        return self._v[7]


def profile_of(events: list):
    """An object read as a finished torch.profiler profile of `events`."""
    prof = type("P", (), {})()
    prof.profiler = type("Q", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda self: events})()
    return prof
