"""Compile and retrace tracking, the port of
``paddle_tpu/observability/compilation.py``.

The JAX package tracks ``jax.jit``: a call whose argument signature
(structure, leaf shapes and dtypes, static values) differs from every
cached trace recompiles.  The port has no jit; what it builds per
signature is

- a kernel library (``_kernels.build``: one ``nvcc`` per source, keyed by
  the library's file name, which carries the source digest),
- a CUDA graph of ``generate``'s single-token step (``models/gpt.py``
  ``_DecodeLoop``: one capture per ``(batch, capacity, temperature,
  top_k)``; a new key is a retrace, and its diff names the changed
  argument),
- a ``torch.export`` program (``jit.save``: one per export signature).

Each reports here through :meth:`CompileTracker.observe` (or
:func:`track_jit` around a callable).  Signatures are the JAX tracker's
strings: the structure as ``PyTreeDef(...)`` and each array leaf as
``float32[2,8]`` (a torch tensor's dtype without the ``torch.`` prefix),
so diffs read the same in both packages.  ``storm_threshold`` retraces of
one function within ``storm_window`` calls flag a retrace storm.

Instruments (per function ``<name>``): counters ``compile.count``,
``compile.cache_hit``, ``compile.retraces``, ``compile.storms``
(``[fn=<name>]``) and the histogram ``compile.wall_ms[fn=<name>]``;
records ``compile`` (one per miss, ``changed`` naming the diffed
arguments) and ``compile.retrace_storm``, which the doctor's
``check_compilation`` reads.
"""
from __future__ import annotations

import functools
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["arg_signature", "diff_signatures", "CompileTracker",
           "track_jit", "track", "get_tracker", "reset_tracker"]


def _describe_leaf(x: Any) -> str:
    """``float32[4,6]`` for array-likes (numpy, torch), a bounded repr for
    everything else."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        name = str(dtype)
        if name.startswith("torch."):
            name = name[len("torch."):]
        return f"{name}[{','.join(str(int(d)) for d in shape)}]"
    r = repr(x)
    return r if len(r) <= 64 else r[:61] + "..."


def _structure(x: Any, leaves: List[Any]) -> str:
    """The structure of ``x`` in ``PyTreeDef`` notation (JAX's pytree
    rules for None, tuples, lists and dicts; anything else is a leaf),
    appending the leaves in JAX's order (dict keys sorted)."""
    if x is None:
        return "None"
    if type(x) is tuple:
        inner = [_structure(e, leaves) for e in x]
        return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") + ")"
    if type(x) is list:
        return "[" + ", ".join(_structure(e, leaves) for e in x) + "]"
    if isinstance(x, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(x[k], leaves)}"
                               for k in sorted(x)) + "}"
    leaves.append(x)
    return "*"


def arg_signature(arg: Any) -> Tuple[str, Tuple[str, ...]]:
    """One argument's signature: (structure, leaf descriptions), as the
    JAX tracker gives them."""
    leaves: List[Any] = []
    tree = _structure(arg, leaves)
    return (f"PyTreeDef({tree})", tuple(_describe_leaf(x) for x in leaves))


def diff_signatures(prev: Sequence[Tuple[str, Tuple[str, ...]]],
                    cur: Sequence[Tuple[str, Tuple[str, ...]]],
                    names: Sequence[str]) -> List[Dict[str, str]]:
    """Name every argument whose signature changed between two traces:
    ``[{"arg": name, "detail": "float32[2,8] -> float32[2,12]"}, ...]``;
    a changed structure reports ``"structure changed"``."""
    changed: List[Dict[str, str]] = []
    for i in range(max(len(prev), len(cur))):
        name = names[i] if i < len(names) else f"arg{i}"
        if i >= len(prev) or i >= len(cur):
            changed.append({"arg": name, "detail": "added/removed"})
            continue
        (ptree, pleaves), (ctree, cleaves) = prev[i], cur[i]
        if ptree != ctree:
            changed.append({"arg": name, "detail": "structure changed"})
            continue
        for j, (a, b) in enumerate(zip(pleaves, cleaves)):
            if a != b:
                detail = f"{a} -> {b}"
                if len(pleaves) > 1:
                    detail = f"leaf {j}: {detail}"
                changed.append({"arg": name, "detail": detail})
                break                      # one leaf names the argument
    return changed


class _FuncState:
    __slots__ = ("names", "seen", "last_sig", "traces", "retraces",
                 "storms", "recent", "calls")

    def __init__(self, names: Sequence[str]):
        self.names = list(names)
        self.seen: set = set()
        self.last_sig: Optional[List[Tuple[str, Tuple[str, ...]]]] = None
        self.traces = 0
        self.retraces = 0
        self.storms = 0
        self.calls = 0
        self.recent: deque = deque(maxlen=64)


class CompileTracker:
    """Process-wide compile / retrace accountant.  ``registry`` defaults
    to the global metrics registry at call time."""

    def __init__(self, registry=None, storm_threshold: int = 3,
                 storm_window: int = 16, max_signatures: int = 4096):
        self._registry = registry
        self.storm_threshold = int(storm_threshold)
        self.storm_window = int(storm_window)
        self.max_signatures = int(max_signatures)
        self._lock = threading.Lock()
        self._funcs: Dict[str, _FuncState] = {}

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from .registry import get_registry
        return get_registry()

    def stats(self, name: str) -> Dict[str, int]:
        with self._lock:
            st = self._funcs.get(name)
            if st is None:
                return {"calls": 0, "traces": 0, "retraces": 0, "storms": 0}
            return {"calls": st.calls, "traces": st.traces,
                    "retraces": st.retraces, "storms": st.storms}

    def functions(self) -> List[str]:
        with self._lock:
            return sorted(self._funcs)

    def reset(self) -> None:
        with self._lock:
            self._funcs.clear()

    def observe(self, name: str, args: Sequence[Any],
                arg_names: Optional[Sequence[str]] = None,
                wall_ms: Optional[float] = None) -> Optional[dict]:
        """Classify one build or call; the ``compile`` record on a miss,
        None on a hit."""
        return self.observe_signatures([arg_signature(a) for a in args],
                                       name=name, arg_names=arg_names,
                                       wall_ms=wall_ms)

    def observe_signatures(self, sigs: List[Tuple[str, Tuple[str, ...]]],
                           name: str,
                           arg_names: Optional[Sequence[str]] = None,
                           wall_ms: Optional[float] = None
                           ) -> Optional[dict]:
        key = hash(tuple(sigs))
        names = list(arg_names or [])
        while len(names) < len(sigs):
            names.append(f"arg{len(names)}")
        reg = self._reg()
        with self._lock:
            st = self._funcs.get(name)
            if st is None:
                st = self._funcs[name] = _FuncState(names)
            st.calls += 1
            hit = key in st.seen
            if not hit:
                if len(st.seen) < self.max_signatures:
                    st.seen.add(key)
                st.traces += 1
                if st.last_sig is not None:
                    st.retraces += 1
            prev, call_idx = st.last_sig, st.calls
            st.last_sig = sigs
        if hit:
            reg.counter(f"compile.cache_hit[fn={name}]").inc()
            return None
        reg.counter(f"compile.count[fn={name}]").inc()
        if wall_ms is not None:
            reg.histogram(f"compile.wall_ms[fn={name}]").observe(wall_ms)
        changed: List[Dict[str, str]] = []
        retrace = prev is not None
        if retrace:
            changed = diff_signatures(prev, sigs, names)
            reg.counter(f"compile.retraces[fn={name}]").inc()
        record = {"function": name, "trace": True, "retrace": retrace,
                  "changed": changed, "wall_ms": wall_ms,
                  "nargs": len(sigs)}
        reg.emit("compile", **record)
        if retrace:
            self._maybe_storm(name, call_idx, changed, reg)
        return record

    def _maybe_storm(self, name: str, call_idx: int,
                     changed: List[Dict[str, str]], reg) -> None:
        with self._lock:
            st = self._funcs[name]
            st.recent.append((call_idx, tuple(c["arg"] for c in changed)))
            window = [(i, args) for i, args in st.recent
                      if call_idx - i < self.storm_window]
            if len(window) < self.storm_threshold:
                return
            freq: Dict[str, int] = {}
            for _i, args in window:
                for a in args:
                    freq[a] = freq.get(a, 0) + 1
            st.storms += 1
            st.recent.clear()                  # re-arm
            retraces = len(window)
        culprits = sorted(freq, key=lambda a: (-freq[a], a))
        reg.counter(f"compile.storms[fn={name}]").inc()
        reg.emit("compile.retrace_storm", function=name,
                 retraces=retraces, window=self.storm_window,
                 culprits=culprits,
                 culprit=(culprits[0] if culprits else None),
                 last_changed=changed)
        from ..framework.log import vlog
        vlog(0, "observability: retrace storm on %s — %d retraces in "
             "%d calls, culprit argument %r", name, retraces,
             self.storm_window, culprits[0] if culprits else "?")


_tracker_lock = threading.Lock()
_tracker: Optional[CompileTracker] = None


def get_tracker() -> CompileTracker:
    """The process-global compile tracker."""
    global _tracker
    with _tracker_lock:
        if _tracker is None:
            _tracker = CompileTracker()
        return _tracker


def reset_tracker() -> None:
    """Drop all per-function compile state (tests)."""
    get_tracker().reset()


def track_jit(fn: Callable, name: Optional[str] = None,
              arg_names: Optional[Sequence[str]] = None,
              tracker: Optional[CompileTracker] = None) -> Callable:
    """Wrap ``fn`` with compile / retrace accounting: each call's
    signature is classified, and a miss is timed (its wall time is the
    build plus the first run)."""
    if name is None:
        name = getattr(fn, "__name__", None) or repr(fn)

    @functools.wraps(fn)
    def tracked(*args, **kwargs):
        tr = tracker or get_tracker()
        try:
            all_args = list(args) + [kwargs[k] for k in sorted(kwargs)]
            sigs = [arg_signature(a) for a in all_args]
            names = list(arg_names) if arg_names else None
            if names is not None and kwargs:
                names = names[:len(args)] + sorted(kwargs)
        except Exception:
            sigs = None                    # tracking never breaks the call
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        if sigs is not None:
            try:
                tr.observe_signatures(
                    sigs, name=name, arg_names=names,
                    wall_ms=(time.perf_counter() - t0) * 1e3)
            except Exception as e:
                from ..framework.log import vlog
                vlog(1, "observability: compile tracking failed for %s: "
                     "%r", name, e)
        return result

    tracked.__tracked_name__ = name
    tracked.__wrapped_fn__ = fn
    return tracked


track = track_jit
