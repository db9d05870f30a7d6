"""Checkpoint conversion, loading and the serving predict function."""
