"""Host-side helpers: metrics and synthetic scenes."""
