"""File I/O (port of ``tpusfm/io``)."""
