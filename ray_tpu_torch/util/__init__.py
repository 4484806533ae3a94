"""Utilities of the port (metrics so far)."""
