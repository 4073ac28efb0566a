"""Dtypes and places: the port of ``paddle_tpu/framework/dtype.py``
(reference phi/common/{data_type,place}.h).

- :func:`convert_dtype` maps a dtype name, a numpy dtype or a torch dtype to
  a torch dtype; :func:`dtype_name` gives its name.
- The places: ``CPUPlace()`` is the host, ``CUDAPlace(i)`` card ``i``,
  ``CUDAPinnedPlace()`` pinned host memory.  ``TPUPlace`` and ``NPUPlace``
  raise ``UnavailableError``: the port runs on an NVIDIA card.
- :func:`set_device` / :func:`get_device` keep the current device of the
  creation API.  As in the JAX package, ``"tpu"``, ``"gpu"`` and ``"cuda"``
  (with ``:N``) land on the default accelerator, here ``cuda:N``; ``"cpu"``
  selects the host.  The default is the card: without one, creation raises
  ``UnavailableError`` until ``set_device("cpu")`` is called or a CPU place
  is passed.
- :func:`as_tensor` is how every op of the tensor API takes its array-like
  arguments: a tensor as it is, anything else (numpy, Python numbers and
  lists) onto the device of the op's tensor arguments, else onto the
  current device.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from .errors import UnavailableError, enforce

__all__ = ["convert_dtype", "dtype_name", "Place", "CPUPlace", "CUDAPlace",
           "CUDAPinnedPlace", "TPUPlace", "NPUPlace", "set_device",
           "get_device", "device_scope", "current_device", "creation_device",
           "set_default_float", "default_float",
           "is_compiled_with_tpu", "as_tensor", "to_numpy"]

# dtype names -> torch dtypes (reference framework.proto VarType :118)
_DTYPE_MAP = {
    "float32": torch.float32, "fp32": torch.float32,
    "float64": torch.float64, "fp64": torch.float64,
    "float16": torch.float16, "fp16": torch.float16,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_NAMES = {v: k for k, v in reversed(list(_DTYPE_MAP.items()))}


def convert_dtype(dtype) -> Optional[torch.dtype]:
    """Normalize a dtype name, a numpy dtype (or scalar type) or a torch
    dtype to a torch dtype; ``None`` stays ``None``."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        try:
            return _DTYPE_MAP[dtype]
        except KeyError:
            raise ValueError(f"unknown dtype {dtype!r}") from None
    name = np.dtype(dtype).name
    enforce(name in _DTYPE_MAP, f"unsupported dtype {dtype!r}",
            exc=ValueError)
    return _DTYPE_MAP[name]


def dtype_name(dtype) -> str:
    return _NAMES[convert_dtype(dtype)]


class Place:
    """Device identity facade (reference phi/common/place.h): a torch
    device, and for pinned host memory a flag."""

    def __init__(self, device: torch.device, pinned: bool = False):
        self._device = torch.device(device)
        self.pinned = pinned

    @property
    def device(self) -> torch.device:
        return self._device

    def __repr__(self):
        return f"Place({self._device}{', pinned' if self.pinned else ''})"

    def __eq__(self, other):
        return (isinstance(other, Place) and self._device == other._device
                and self.pinned == other.pinned)

    def __hash__(self):
        return hash((self._device, self.pinned))


def CPUPlace() -> Place:
    return Place(torch.device("cpu"))


def CUDAPlace(index: int = 0) -> Place:
    return Place(torch.device("cuda", int(index)))


def CUDAPinnedPlace() -> Place:
    """Host memory pinned for copies to the card."""
    return Place(torch.device("cpu"), pinned=True)


def TPUPlace(index: int = 0) -> Place:
    raise UnavailableError(
        "TPUPlace: the PyTorch port runs on an NVIDIA card; use "
        "CUDAPlace(index) or set_device('gpu')")


def NPUPlace(index: int = 0) -> Place:
    raise UnavailableError(
        "NPUPlace: the PyTorch port runs on an NVIDIA card; use "
        "CUDAPlace(index) or set_device('gpu')")


# the float dtype of creation ops given no dtype (paddle.set_default_dtype)
_default_float = torch.float32


def set_default_float(dtype) -> None:
    global _default_float
    d = convert_dtype(dtype)
    if not d.is_floating_point:
        raise TypeError(f"default dtype must be floating, got {d}")
    _default_float = d


def default_float() -> torch.dtype:
    return _default_float


# None: the default, the card (cuda:0)
_current: Optional[Place] = None


def set_device(device: str) -> Place:
    """paddle.set_device analog: ``'cpu'``, or ``'gpu'`` / ``'cuda'`` /
    ``'tpu'`` (with ``:N``), which select ``cuda:N``."""
    global _current
    enforce(isinstance(device, str), f"device must be a string, got "
            f"{device!r}", exc=ValueError)
    if device == "cpu":
        _current = CPUPlace()
    elif device.startswith(("tpu", "gpu", "cuda", "npu", "xpu")):
        idx = int(device.split(":")[1]) if ":" in device else 0
        _current = CUDAPlace(idx)
    else:
        raise ValueError(f"unknown device {device!r}")
    return _current


def get_device() -> str:
    """``'gpu:N'`` for card N (the default, ``'gpu:0'``), ``'cpu'`` for the
    host."""
    dev = current_device()
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index or 0}"


@contextlib.contextmanager
def device_scope(device: str):
    """:func:`set_device` for the body of a ``with`` block; the device that
    was current before is restored on the way out."""
    global _current
    prev = _current
    set_device(device)
    try:
        yield current_device()
    finally:
        _current = prev


def current_device() -> torch.device:
    """The device :func:`set_device` selected (``cuda``, the current
    card, by default)."""
    return torch.device("cuda") if _current is None else _current.device


def creation_device(place=None) -> torch.device:
    """Where a creation op puts its tensor: ``place`` (a ``Place``, a
    torch device or a device string) when given, else the current device;
    a CUDA device without a card raises ``UnavailableError``."""
    if place is None:
        dev = current_device()
    elif isinstance(place, Place):
        dev = place.device
    else:
        dev = torch.device(place)
    if dev.type == "cuda":
        enforce(torch.cuda.is_available(),
                "no CUDA device is visible: the tensor API creates tensors "
                "on the card by default; call set_device('cpu') or pass "
                "place=CPUPlace() to work on the CPU",
                exc=UnavailableError)
    return dev


def is_compiled_with_tpu() -> bool:
    return False


def _like_device(like) -> Optional[torch.device]:
    if isinstance(like, torch.Tensor):
        return like.device
    if isinstance(like, (list, tuple)):
        for item in like:
            dev = _like_device(item)
            if dev is not None:
                return dev
    return None


def as_tensor(x, like=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor.  A tensor is returned as it is (cast when
    ``dtype`` is given); a numpy array keeps its dtype; Python floats
    take the default float dtype (:func:`set_default_float`, float32),
    ints become int64 and bools bool.  A new tensor lands on the
    device of the first tensor in ``like`` (a tensor or a nested sequence)
    and else on the current device."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(convert_dtype(dtype))
    if isinstance(x, (list, tuple)) and any(isinstance(i, torch.Tensor)
                                            for i in x):
        out = torch.stack([as_tensor(i, like=x) for i in x])
        return out if dtype is None else out.to(convert_dtype(dtype))
    native = isinstance(x, (np.ndarray, np.generic))
    a = np.asarray(x)
    if not native and a.dtype == np.float64 and dtype is None:
        dtype = _default_float
    dev = _like_device(like)
    if dev is None:
        dev = creation_device()
    return torch.tensor(a, device=dev, dtype=convert_dtype(dtype))


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.resolve_conj().cpu().numpy()
    return np.asarray(x)
