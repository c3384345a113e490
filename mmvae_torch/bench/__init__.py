"""Benchmarks of the port on one GPU."""
