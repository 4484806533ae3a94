"""Utilities of the port: device choice, metrics, trees, placement
groups and scheduling strategies, the serve chaos injector and the
serve part of the state API."""
