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
  drawing one never waits for the card;
- :func:`get_state` / :func:`set_state` snapshot and restore every stream:
  activation recompute replays a block's forward from the snapshot taken
  before it (``torch.utils.checkpoint``'s RNG preservation covers only
  torch's default generators), and a checkpoint carries the streams so a
  resumed run draws what the uninterrupted one would.

JAX's threefry keys and torch's Philox streams give different numbers from
one seed, so the port's masks are reproducible per seed but are not JAX's;
tests hand both packages the same explicit hash seeds instead.
"""
from __future__ import annotations

import threading
from typing import Dict, Union

import torch

__all__ = ["seed", "generator", "draw_seed", "get_state", "set_state"]

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


def get_state() -> Dict[str, torch.Tensor]:
    """Every stream's state, by device name (``"cpu"``, ``"cuda:0"``): the
    ``uint8`` CPU tensors of ``torch.Generator.get_state``.  The CPU stream
    is created first if no draw has made it yet."""
    generator("cpu")
    with _lock:
        return {str(dev): gen.get_state()
                for dev, gen in _generators.items()}


def set_state(state: Dict[str, torch.Tensor]) -> None:
    """Restore the streams of a :func:`get_state` (a stream it does not
    name is left as it is)."""
    for name, value in state.items():
        generator(name).set_state(torch.as_tensor(value, dtype=torch.uint8)
                                  .cpu())
