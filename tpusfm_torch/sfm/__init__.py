"""Structure from motion: RANSAC, resection, tracks, scene and the incremental engine."""
