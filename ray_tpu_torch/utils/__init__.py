"""Utilities of the port that the runtime stands on (the task-event log
so far)."""
