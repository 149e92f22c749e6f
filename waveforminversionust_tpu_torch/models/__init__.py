"""Grids, acquisition geometry and phantoms (numpy)."""
