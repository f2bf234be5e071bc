"""pcg_host_us_per_iter: host microseconds in the CG loop
(``tpusfm.ba.pcg``) outside its flag reads (``tpusfm.ba.pcg.stop_read``),
per CG product; read by ``spansum.per_layer`` from the spans that
the harness keeps of the traced solves."""

from sfmbench import spansum


def read(run):
    if run.trace is None:
        return None
    return spansum.per_layer(run.trace.spans).get("pcg_host_us_per_iter")
