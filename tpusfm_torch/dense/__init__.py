"""Dense stages: plane sweep, PatchMatch, consistency fusion, TSDF meshing
and texturing (port of ``tpusfm/dense``)."""
