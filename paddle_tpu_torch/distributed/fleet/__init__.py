"""Fleet utilities of the port (activation recompute)."""
