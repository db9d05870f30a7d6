"""Checkpoint conversion (Mamba-UNet and Mamba-LM), loading and the
serving predict function."""
