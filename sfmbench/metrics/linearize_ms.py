"""linearize_ms: the mean completion of the ``tpusfm.ba.linearize`` span,
from its start to the end of the last device work launched inside it, in
milliseconds; read by ``spansum.per_layer`` from the spans that
the harness keeps of the traced solves."""

from sfmbench import spansum


def read(run):
    if run.trace is None:
        return None
    return spansum.per_layer(run.trace.spans).get("linearize_ms")
