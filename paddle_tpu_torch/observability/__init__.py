"""Observability the serving engine needs: the metrics registry and its
sinks, request-trace emission and the status server (the port's own
copies of the JAX package's modules of the same names)."""
