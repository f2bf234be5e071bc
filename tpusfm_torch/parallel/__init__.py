"""Multi-device runtime on torch.distributed (port of ``tpusfm/parallel``):
the process-group mesh, sharded matching, ring matching, distributed BA
and view-sharded dense depth."""
