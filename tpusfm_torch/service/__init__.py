"""HTTP service (port of ``tpusfm/service``)."""
