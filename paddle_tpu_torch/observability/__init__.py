"""Observability of the port (its own copies of the JAX package's modules
of the same names): the metrics registry and its sinks, span tracing,
MFU on an H100 row, device-memory sampling, the crash flight recorder,
request-trace emission and assembly with tail attribution, cross-worker
aggregation, the run doctor and the live monitor (status server and live
aggregator).

Not ported yet: ``compilation`` / ``compilecache`` (they track
``jax.jit``), ``roofline`` (it parses XLA's compiled HLO) and
``interconnect`` (the TPU ICI tables); H100 and NVLink counterparts come
with the port's bench."""
from .aggregate import (StreamTail, aggregate_run,  # noqa: F401
                        read_worker_stream, straggler_stats)
from .doctor import diagnose, render_report  # noqa: F401
from .flight import (FlightRecorder, flight_dir,  # noqa: F401
                     read_flight_bundles)
from .memory import (MemorySampler, get_sampler, is_oom_error,  # noqa: F401
                     oom_postmortem)
from .mfu import (DEVICE_SPECS, PEAK_TFLOPS, device_spec,  # noqa: F401
                  flops_per_token, mfu, param_count, peak_flops_per_sec,
                  readback_sync)
from .monitor import (LiveAggregator, StatusServer,  # noqa: F401
                      default_monitor_interval, live_status_path,
                      maybe_start_server)
from .registry import (Counter, Gauge, Histogram,  # noqa: F401
                       MetricsRegistry, get_registry, split_labels)
from .requesttrace import (TraceAssembler, assemble_run,  # noqa: F401
                           component_bucket, mint_trace_id,
                           tail_latency_attribution)
from .sinks import (MetricsWriter, PrometheusTextfile,  # noqa: F401
                    StderrSummary, default_interval, metrics_dir,
                    render_prometheus)
from .tracing import (export_chrome_trace, reset_tracing,  # noqa: F401
                      span, span_tree_totals, trace_events)

__all__ = [
    # registry
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "split_labels",
    # tracing
    "span", "span_tree_totals", "export_chrome_trace", "trace_events",
    "reset_tracing",
    # sinks
    "MetricsWriter", "StderrSummary", "PrometheusTextfile", "metrics_dir",
    "default_interval", "render_prometheus",
    # mfu
    "PEAK_TFLOPS", "peak_flops_per_sec", "param_count", "flops_per_token",
    "mfu", "readback_sync", "DEVICE_SPECS", "device_spec",
    # aggregation
    "aggregate_run", "read_worker_stream", "straggler_stats", "StreamTail",
    # live monitor
    "StatusServer", "LiveAggregator", "maybe_start_server",
    "default_monitor_interval", "live_status_path",
    # flight recorder
    "FlightRecorder", "flight_dir", "read_flight_bundles",
    # memory watermarks
    "MemorySampler", "get_sampler", "is_oom_error", "oom_postmortem",
    # run doctor
    "diagnose", "render_report",
    # request tracing (the chrome exporter of traces stays
    # requesttrace.export_chrome_trace, beside the span exporter above)
    "TraceAssembler", "assemble_run", "tail_latency_attribution",
    "mint_trace_id", "component_bucket",
]
