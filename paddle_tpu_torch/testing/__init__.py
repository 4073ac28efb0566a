"""Test seams of the port: the serving fault injectors (``faults``)."""
