"""Feature detection and description."""
