"""The framework's random streams: the port of ``paddle_tpu/framework/
random.py`` (``seed``, the default generator) for PyTorch.

Every stochastic op of the port draws from an explicit ``torch.Generator``
kept here, one per device, never from torch's global default generator:
a training step that draws dropout masks or hash-dropout seeds leaves
``torch.random.get_rng_state()`` as it found it.

- :func:`generator` is the stream of one device (created on first use,
  seeded with the last :func:`seed`); dropout masks on that device are
  drawn from it;
- :func:`draw_seed` is an int32 seed for the counter-hash dropout of the
  flash and fused-block ops, drawn on the host from the CPU stream, so
  drawing one never waits for the card.

JAX's threefry keys and torch's Philox streams give different numbers from
one seed, so the port's masks are reproducible per seed but are not JAX's;
tests hand both packages the same explicit hash seeds instead.
"""
from __future__ import annotations

import threading
from typing import Dict, Union

import torch

__all__ = ["seed", "generator", "draw_seed"]

_lock = threading.Lock()
_seed = 0
_generators: Dict[torch.device, torch.Generator] = {}


def _key(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def seed(value: int) -> None:
    """paddle.seed analog: reseed every device's stream with ``value``."""
    global _seed
    with _lock:
        _seed = int(value)
        for gen in _generators.values():
            gen.manual_seed(_seed)


def generator(device: Union[str, torch.device] = "cpu") -> torch.Generator:
    """The explicit generator of ``device``."""
    dev = _key(device)
    with _lock:
        gen = _generators.get(dev)
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(_seed)
            _generators[dev] = gen
    return gen


def draw_seed() -> int:
    """A fresh int32 hash-dropout seed in [0, 2**31 - 1) from the host
    stream."""
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=generator("cpu")))
