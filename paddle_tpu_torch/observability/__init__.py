"""Observability of the port (its own copies of the JAX package's modules
of the same names): the metrics registry and its sinks, request-trace
emission and the status server (serving), span tracing, MFU on an H100
row, device-memory sampling and the crash flight recorder (training)."""
