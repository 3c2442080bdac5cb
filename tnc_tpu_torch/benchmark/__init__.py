"""Benchmark plans of the port (the north-star plan)."""
