"""Host utilities the port needs (its own copies, no JAX)."""
