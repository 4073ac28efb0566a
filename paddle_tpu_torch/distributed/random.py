"""Model-parallel RNG tracking: the port of
``paddle_tpu/distributed/random.py`` (``RNGStatesTracker``,
``model_parallel_random_seed``; reference fleet/meta_parallel/
parallel_layers/random.py:32, :82).

Megatron's rule: dropout on an activation that every mp rank holds whole
(the residual stream, after a row-parallel all-reduce) must draw the same
mask on every mp rank, or the replicas drift apart; dropout on an
activation each mp rank holds a shard of (the attention probabilities of
its own heads) must draw different masks.  The JAX package folds the mesh
index into a threefry key; here a named stream is a set of per-device
``torch.Generator``s of the framework (``framework/random.py``
``add_stream``), and a stream with ``local_axis`` is seeded with the
rank's coordinate on that axis folded in.  Inside ``with
tracker.rng_state(name)`` every draw of the thread (dropout masks, the
flash and fused-block hash seeds) comes from that stream; activation
recompute snapshots and replays the named streams with the default ones.

:func:`model_parallel_random_seed` seeds the global stream with the same
seed on every mp rank (a different one per dp replica and per pipeline
stage) and ``MODEL_PARALLEL_RNG`` with the mp rank folded in.  The masks
are the port's own: torch's Philox streams are not JAX's threefry keys,
as every random stream of the port already differs from the JAX one.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

from ..framework import random as fw_random
from ..framework.errors import enforce
from . import topology as topo

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "MODEL_PARALLEL_RNG",
           "local_seed"]

MODEL_PARALLEL_RNG = "model_parallel_rng"


def local_seed(seed: int, index: int) -> int:
    """``seed`` with an axis index folded in (a fixed odd multiplier keeps
    the streams of neighbouring indices apart), as an int63."""
    return (int(seed) + 0x9E3779B97F4A7C15 * (int(index) + 1)) % (2 ** 63)


class RNGStatesTracker:
    """Named streams with scoped activation (reference random.py:32)."""

    def __init__(self):
        self._seeds: Dict[str, int] = {}
        self._local_axes: Dict[str, Optional[str]] = {}

    def reset(self) -> None:
        self._seeds.clear()
        self._local_axes.clear()
        fw_random.remove_streams()

    def add(self, name: str, seed: int,
            local_axis: Optional[str] = None) -> None:
        """Register a named stream.  ``local_axis``: a hybrid axis whose
        coordinate is folded into the seed, so each rank along it draws
        its own numbers (the reference's ``seed + tp_rank``)."""
        enforce(name not in self._seeds, f"rng state {name!r} already exists")
        value = seed if local_axis is None else local_seed(
            seed, topo.axis_rank(local_axis))
        fw_random.add_stream(name, value)
        self._seeds[name] = int(seed)
        self._local_axes[name] = local_axis

    def get_states_tracker(self) -> Dict[str, int]:
        return dict(self._seeds)

    @contextlib.contextmanager
    def rng_state(self, name: str = MODEL_PARALLEL_RNG) -> Iterator[None]:
        """Every draw of this thread inside comes from the named stream."""
        enforce(name in self._seeds, f"unknown rng state {name!r}")
        with fw_random.use_stream(name):
            yield

    def active_name(self) -> Optional[str]:
        return fw_random.active_stream()

    def has(self, name: str) -> bool:
        return name in self._seeds


_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _tracker


def model_parallel_random_seed(seed: int = 100) -> None:
    """Seed the global stream (the framework's default: equal on the mp
    ranks of one dp replica and pipeline stage) and MODEL_PARALLEL_RNG
    (different on every mp rank).  Without a hybrid group every index is
    0 and the global stream is ``seed`` itself."""
    _tracker.reset()
    global_seed = seed
    if topo.get_hybrid_communicate_group() is not None:
        global_seed = local_seed(
            seed, topo.axis_rank("dp") * 1009 + topo.axis_rank("pp")) \
            if (topo.axis_size("dp") > 1 or topo.axis_size("pp") > 1) \
            else seed
    fw_random.seed(global_seed)
    _tracker.add("global_seed", seed)
    _tracker.add(MODEL_PARALLEL_RNG, seed + 2718, local_axis="mp")
