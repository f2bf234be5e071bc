"""cg_iters_per_step: CG products (``tpusfm.ba.pcg.matvec`` instances)
per CG loop (``tpusfm.ba.pcg`` instances); read by ``spansum.per_layer`` from the spans that
the harness keeps of the traced solves."""

from sfmbench import spansum


def read(run):
    if run.trace is None:
        return None
    return spansum.per_layer(run.trace.spans).get("cg_iters_per_step")
