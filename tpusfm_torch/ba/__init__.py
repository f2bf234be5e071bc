"""Bundle adjustment."""
