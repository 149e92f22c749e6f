"""Dataset synthesis."""
