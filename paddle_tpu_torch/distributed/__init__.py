"""Parallel layers of the port (serial, single-card forms)."""
