"""File I/O (port of ``tpusfm/io``; ``ply`` so far)."""
