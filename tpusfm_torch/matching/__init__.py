"""Pair generation and descriptor matching."""
