"""Pipeline configuration, the sparse entry point, the staged workspace pipeline and checkpoints."""
