"""View-packed dense dispatch (port of ``tpusfm/parallel``; the single-device
part of ``dist_dense`` so far)."""
