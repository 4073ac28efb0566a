"""Test seams of the port: the checkpoint, training, serving and fleet
fault injectors (``faults``)."""
