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
  resumed run draws what the uninterrupted one would;
- named streams (:func:`add_stream`, :func:`use_stream`) are further sets
  of per-device generators with seeds of their own: inside ``with
  use_stream(name)`` every draw of this thread (:func:`generator`,
  :func:`draw_seed`) comes from that set.  The model-parallel RNG tracker
  (``distributed/random.py``) keeps its streams here, so recompute's
  snapshot covers them too.

JAX's threefry keys and torch's Philox streams give different numbers from
one seed, so the port's masks are reproducible per seed but are not JAX's;
tests hand both packages the same explicit hash seeds instead.
"""
from __future__ import annotations

import threading
import contextlib
from typing import Dict, Iterator, Optional, Tuple, Union

import torch

__all__ = ["seed", "generator", "draw_seed", "get_state", "set_state",
           "add_stream", "remove_streams", "use_stream", "active_stream"]

_lock = threading.Lock()
_seed = 0
_generators: Dict[torch.device, torch.Generator] = {}
# named streams: name -> (seed, {device: generator})
_named: Dict[str, Tuple[int, Dict[torch.device, torch.Generator]]] = {}
_tls = threading.local()


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
    """The explicit generator of ``device``: the default stream's, or the
    named stream's inside :func:`use_stream`."""
    dev = _key(device)
    name = active_stream()
    with _lock:
        if name is None:
            table, value = _generators, _seed
        else:
            value, table = _named[name]
        gen = table.get(dev)
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(value)
            table[dev] = gen
    return gen


def add_stream(name: str, value: int) -> None:
    """Register the named stream ``name``, seeded with ``value`` on every
    device.  Its CPU generator and the current card's are made now, so a
    :func:`get_state` snapshot taken before the stream's first draw holds
    them (recompute replays a block from such a snapshot)."""
    with _lock:
        if name in _named:
            raise ValueError(f"random stream {name!r} already exists")
        _named[name] = (int(value), {})
    with use_stream(name):
        generator("cpu")
        if torch.cuda.is_available():
            generator("cuda")


def remove_streams() -> None:
    """Forget every named stream."""
    with _lock:
        _named.clear()


def active_stream() -> Optional[str]:
    """The named stream this thread draws from, None for the default."""
    return getattr(_tls, "active", None)


@contextlib.contextmanager
def use_stream(name: str) -> Iterator[None]:
    """Draw from the named stream ``name`` inside the block (this
    thread)."""
    if name not in _named:
        raise KeyError(f"unknown random stream {name!r}")
    prev = active_stream()
    _tls.active = name
    try:
        yield
    finally:
        _tls.active = prev


def draw_seed() -> int:
    """A fresh int32 hash-dropout seed in [0, 2**31 - 1) from the host
    stream."""
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=generator("cpu")))


def get_state() -> Dict[str, torch.Tensor]:
    """Every stream's state, by device name (``"cpu"``, ``"cuda:0"``;
    ``"<stream>/<device>"`` for a named stream's generators): the
    ``uint8`` CPU tensors of ``torch.Generator.get_state``.  The default
    CPU stream is created first if no draw has made it yet."""
    with _lock:
        if torch.device("cpu") not in _generators:
            gen = torch.Generator(device="cpu")
            gen.manual_seed(_seed)
            _generators[torch.device("cpu")] = gen
        out = {str(dev): gen.get_state()
               for dev, gen in _generators.items()}
        for name, (_, table) in _named.items():
            out.update({f"{name}/{dev}": gen.get_state()
                        for dev, gen in table.items()})
        return out


def set_state(state: Dict[str, torch.Tensor]) -> None:
    """Restore the streams of a :func:`get_state` (a stream it does not
    name is left as it is; a named stream this process has not registered
    is skipped)."""
    for key, value in state.items():
        name, _, dev = key.rpartition("/")
        if name and name not in _named:
            continue
        ctx = use_stream(name) if name else contextlib.nullcontext()
        with ctx:
            generator(dev).set_state(torch.as_tensor(value, dtype=torch.uint8)
                                     .cpu())
