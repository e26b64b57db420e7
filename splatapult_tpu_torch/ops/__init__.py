"""Tiled pipeline: binning, composite and image assembly."""
