"""Projection, SH and transform math (plain PyTorch)."""
