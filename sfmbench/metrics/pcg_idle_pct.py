"""pcg_idle_pct: the seconds in which the device ran nothing while the CG
loop or one of its children was the innermost span, over the CG loop's host
seconds, in percent; read by ``spansum.per_layer`` from the spans that
the harness keeps of the traced solves."""

from sfmbench import spansum


def read(run):
    if run.trace is None:
        return None
    return spansum.per_layer(run.trace.spans).get("pcg_idle_pct")
