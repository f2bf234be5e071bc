"""Command-line measurement tools for the port (run with ``python -m``)."""
