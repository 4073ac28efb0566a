"""Framework pieces the port needs (its own copies, no JAX)."""
