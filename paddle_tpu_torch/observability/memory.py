"""Per-step device-memory accounting: the port of ``paddle_tpu/
observability/memory.py`` on PyTorch's caching allocator.

``torch.cuda.memory_stats()`` is the ground truth for memory pressure on
the card: a run that creeps toward the limit starts fragmenting, then
retrying allocations, then raises ``torch.cuda.OutOfMemoryError``; by
then the interesting state is gone.  This module samples the watermark
table on a step cadence and keeps the last table so an OOM leaves a
postmortem.

- :class:`MemorySampler` samples every ``PTPU_MEM_SAMPLE_EVERY`` steps
  (default 16).  Each sample emits one ``memory`` record with the
  per-device table plus deltas against the previous sample, and sets the
  gauges ``memory.bytes_in_use[device=..]``, ``memory.peak_bytes[..]``
  and ``memory.utilization[..]``.
- :func:`oom_postmortem`, called when a step dies with an allocator error
  (:func:`is_oom_error`), emits a ``memory.oom`` record carrying the
  last-known table per device: the state before the allocation that
  killed the step.

The table keeps the JAX package's key names: ``bytes_in_use`` (the
allocator's ``allocated_bytes.all.current``), ``peak_bytes_in_use``
(``allocated_bytes.all.peak``), ``bytes_reserved``
(``reserved_bytes.all.current``), ``bytes_limit`` (the card's total
memory), ``num_allocs`` (``allocation.all.current``) and
``num_alloc_retries`` / ``num_ooms``.  Without a card the table is empty
and the sampler emits nothing.  Tests inject ``stats_fn``.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional

__all__ = ["MEM_SAMPLE_ENV", "MemorySampler", "default_sample_every",
           "device_stats_table", "is_oom_error", "oom_postmortem",
           "get_sampler"]

MEM_SAMPLE_ENV = "PTPU_MEM_SAMPLE_EVERY"

# the keys a watermark table carries
_KEYS = ("bytes_in_use", "peak_bytes_in_use", "largest_alloc_size",
         "bytes_limit", "bytes_reserved", "num_allocs",
         "num_alloc_retries", "num_ooms")

# table key <- torch.cuda.memory_stats key
_TORCH_KEYS = {"bytes_in_use": "allocated_bytes.all.current",
               "peak_bytes_in_use": "allocated_bytes.all.peak",
               "bytes_reserved": "reserved_bytes.all.current",
               "num_allocs": "allocation.all.current",
               "num_alloc_retries": "num_alloc_retries",
               "num_ooms": "num_ooms"}


def default_sample_every() -> int:
    return max(1, int(os.environ.get(MEM_SAMPLE_ENV, "16")))


def device_stats_table() -> Dict[str, Dict[str, int]]:
    """{``cuda:<i>``: watermark table} for every visible card whose
    allocator has been used; empty without a card."""
    import torch
    if not torch.cuda.is_available():
        return {}
    out: Dict[str, Dict[str, int]] = {}
    for i in range(torch.cuda.device_count()):
        if not torch.cuda.is_initialized():
            break
        stats = torch.cuda.memory_stats(i)
        if not stats:
            continue
        row = {k: int(stats[v]) for k, v in _TORCH_KEYS.items()
               if v in stats}
        row["bytes_limit"] = int(
            torch.cuda.get_device_properties(i).total_memory)
        out[f"cuda:{i}"] = row
    return out


class MemorySampler:
    """Step-cadenced device-memory watermark sampler.

    ``stats_fn`` returns the per-device table (default
    :func:`device_stats_table`); ``every`` defaults to the
    ``PTPU_MEM_SAMPLE_EVERY`` knob.  ``sample(step)`` is a no-op off
    cadence, so it can sit in the per-step telemetry path."""

    def __init__(self, every: Optional[int] = None,
                 stats_fn: Optional[Callable[[], Dict[str, Dict[str, int]]]]
                 = None, registry=None):
        self.every = default_sample_every() if every is None else max(
            1, int(every))
        self._stats_fn = stats_fn or device_stats_table
        self._registry = registry
        self._lock = threading.Lock()
        self._prev: Dict[str, Dict[str, int]] = {}
        self.last_table: Dict[str, Dict[str, Any]] = {}
        self.last_step: Optional[int] = None
        self.samples = 0

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from .registry import get_registry
        return get_registry()

    def sample(self, step: Optional[int] = None,
               force: bool = False) -> Optional[Dict[str, Any]]:
        """Take one sample (off-cadence calls return None).  The emitted
        ``memory`` record carries, per device, the watermark keys plus
        ``in_use_delta`` / ``largest_alloc_delta`` against the previous
        sample: the creep a doctor trends on."""
        if not force and step is not None and step % self.every != 0:
            return None
        try:
            table = {dev: {k: int(v) for k, v in stats.items()
                           if k in _KEYS}
                     for dev, stats in self._stats_fn().items()}
        except Exception as e:  # sampling must never hurt the run
            from ..framework.log import vlog
            vlog(1, "observability: memory sample failed: %r", e)
            return None
        if not table:
            return None
        reg = self._reg()
        devices: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            prev = self._prev
            for dev, stats in table.items():
                row: Dict[str, Any] = dict(stats)
                p = prev.get(dev, {})
                if "bytes_in_use" in stats:
                    row["in_use_delta"] = (
                        stats["bytes_in_use"] - p.get("bytes_in_use",
                                                      stats["bytes_in_use"]))
                if "largest_alloc_size" in stats:
                    row["largest_alloc_delta"] = (
                        stats["largest_alloc_size"]
                        - p.get("largest_alloc_size",
                                stats["largest_alloc_size"]))
                limit = stats.get("bytes_limit")
                if limit:
                    row["utilization"] = stats.get("bytes_in_use", 0) / limit
                devices[dev] = row
            self._prev = table
            self.last_table = devices
            self.last_step = step
            self.samples += 1
        for dev, row in devices.items():
            if "bytes_in_use" in row:
                reg.gauge(f"memory.bytes_in_use[device={dev}]").set(
                    row["bytes_in_use"])
            if "peak_bytes_in_use" in row:
                reg.gauge(f"memory.peak_bytes[device={dev}]").set(
                    row["peak_bytes_in_use"])
            if "utilization" in row:
                reg.gauge(f"memory.utilization[device={dev}]").set(
                    row["utilization"])
        record = {"step": step, "devices": devices}
        reg.emit("memory", **record)
        return record


def is_oom_error(exc: BaseException) -> bool:
    """Does this exception look like a device allocator OOM?
    ``torch.cuda.OutOfMemoryError``, or a message saying so."""
    try:
        import torch
        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
    except (ImportError, AttributeError):
        pass
    msg = str(exc).lower()
    return ("out of memory" in msg or "resource_exhausted" in msg
            or ("allocating" in msg and "exceeds" in msg))


def oom_postmortem(sampler: Optional[MemorySampler] = None,
                   error: Optional[BaseException] = None,
                   step: Optional[int] = None) -> Dict[str, Any]:
    """Emit the last-known watermark table per device as a ``memory.oom``
    record (and return it).  Tries one fresh sample first: the allocator
    usually survives the failed allocation, and the current table shows
    how full each card is."""
    sampler = sampler or get_sampler()
    try:
        sampler.sample(step=step, force=True)
    except Exception:  # noqa: swallow
        pass  # the stale table below is still the best evidence
    table = sampler.last_table
    reg = sampler._reg()
    reg.counter("memory.oom_count").inc()
    record = {"step": step if step is not None else sampler.last_step,
              "error": (f"{type(error).__name__}: {error}"[:512]
                        if error is not None else None),
              "devices": table}
    reg.emit("memory.oom", **record)
    from ..framework.log import vlog
    vlog(0, "observability: OOM postmortem - %d device watermark rows "
         "recorded", len(table))
    return record


_sampler_lock = threading.Lock()
_sampler: Optional[MemorySampler] = None


def get_sampler() -> MemorySampler:
    """The process-global sampler (honors ``PTPU_MEM_SAMPLE_EVERY``)."""
    global _sampler
    with _sampler_lock:
        if _sampler is None:
            _sampler = MemorySampler()
        return _sampler
