"""Shared data structures."""
