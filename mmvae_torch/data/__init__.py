"""Data transforms of the port."""
