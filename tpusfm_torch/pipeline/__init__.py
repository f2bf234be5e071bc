"""Pipeline configuration and the sparse entry point."""
