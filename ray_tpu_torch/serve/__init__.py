"""Serving of the port (the LLM engine so far)."""
