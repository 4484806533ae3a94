"""Attention ops of the port: each kernel's wrapper, plain version and
launch counter live in the module named after its JAX counterpart."""
