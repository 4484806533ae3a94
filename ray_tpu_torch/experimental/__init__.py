"""Experimental planes of the port: the shared-memory channels and the
Communicator seam that compiled graphs ride (`channel`)."""
