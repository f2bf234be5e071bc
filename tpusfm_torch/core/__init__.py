"""Geometry core: Lie groups, camera models, minimal solvers, triangulation."""

from . import camera, epipolar, homography, lie, triangulate  # noqa: F401
