"""Geometry core: Lie groups, camera models, minimal solvers, triangulation."""
