"""Contraction paths, cost models and path finders."""
