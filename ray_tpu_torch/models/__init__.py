"""Model families of the port (GPT-2 so far)."""
