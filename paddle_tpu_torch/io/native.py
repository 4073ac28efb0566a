"""The native shared-memory transport of ``io.DataLoader``: the port of
``paddle_tpu/io/native.py``, the ``ctypes`` binding of the port's own
``io/_native/shm_ring.cc`` and the batch codec (reference
mmap_allocator.cc + lod_tensor_blocking_queue.h).

A batch crosses the ring as ``[u32 meta_len][pickled meta][raw array
buffers]``: only the metadata (batch id, error, the nesting of the batch,
each array's dtype and shape) is pickled; the arrays are gathered
straight into the shared slot (``srq_put``'s iovecs) and rebuilt with
``np.frombuffer`` on the parent's side, so a batch arrives byte for byte
as the worker collated it.  The library is built at first use by
``utils.cpp_extension.load`` (``g++``) into the gitignored ``build/``;
without a compiler :func:`native_available` is False and the loader
keeps the worker queue, as the JAX loader does.
"""
from __future__ import annotations

import ctypes
import mmap
import os
import pickle
import struct
import threading
from typing import Any, List, Optional, Tuple

import numpy as np

from ..framework.log import get_logger

__all__ = ["ShmRing", "load_library", "native_available",
           "encode_batch_parts", "decode_batch"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native",
                    "shm_ring.cc")

_lib = None
_lib_lock = threading.Lock()


class _Iovec(ctypes.Structure):
    _fields_ = [("base", ctypes.c_void_p), ("len", ctypes.c_uint64)]


def load_library():
    """The ``ctypes`` handle, built on first use; None when it cannot be
    built (the loader then keeps the worker queue)."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib or None
        from ..utils.cpp_extension import load
        try:
            lib = load("shm_ring", [_SRC], extra_ldflags=["-lpthread"])
        except Exception as e:  # noqa: a missing toolchain leaves the queue
            get_logger().warning("native dataloader core build failed: %s",
                                 e)
            _lib = False
            return None
        lib.srq_size.restype = ctypes.c_uint64
        lib.srq_size.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
        lib.srq_init.restype = ctypes.c_int
        lib.srq_init.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                 ctypes.c_uint64]
        lib.srq_put.restype = ctypes.c_int
        lib.srq_put.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Iovec),
                                ctypes.c_uint64, ctypes.c_double]
        lib.srq_get.restype = ctypes.c_int64
        lib.srq_get.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_uint64, ctypes.c_double]
        lib.srq_close.restype = None
        lib.srq_close.argtypes = [ctypes.c_void_p]
        lib.srq_count.restype = ctypes.c_uint64
        lib.srq_count.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_library() is not None


class ShmRing:
    """A fixed-slot multi-producer, single-consumer ring in an anonymous
    shared mapping.  Create it in the parent before forking the workers:
    they inherit the mapping, so there is nothing to name or unlink."""

    def __init__(self, slots: int = 8, slot_bytes: int = 32 << 20):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native dataloader core unavailable")
        self._lib = lib
        self.slots = slots
        self.slot_bytes = slot_bytes
        size = int(lib.srq_size(slots, slot_bytes))
        self._mm = mmap.mmap(-1, size)  # MAP_SHARED | MAP_ANONYMOUS
        self._addr = ctypes.addressof(ctypes.c_char.from_buffer(self._mm))
        rc = lib.srq_init(self._addr, slots, slot_bytes)
        if rc != 0:
            raise RuntimeError(f"srq_init failed rc={rc}")
        self._scratch = bytearray(slot_bytes)

    def put_parts(self, parts: List[Any], timeout: float = 60.0) -> None:
        """Write buffer-protocol objects, gathered, as one message."""
        n = len(parts)
        iov = (_Iovec * n)()
        keep = []  # the buffers stay referenced until the call returns
        for i, p in enumerate(parts):
            mv = (memoryview(np.ascontiguousarray(p)).cast("B")
                  if isinstance(p, np.ndarray) else memoryview(p).cast("B"))
            if mv.readonly:
                ro = bytes(mv)
                keep.append(ro)
                iov[i].base = ctypes.cast(ctypes.c_char_p(ro),
                                          ctypes.c_void_p)
                iov[i].len = len(ro)
            else:
                buf = (ctypes.c_char * mv.nbytes).from_buffer(mv)
                keep.append((mv, buf))
                iov[i].base = ctypes.addressof(buf)
                iov[i].len = mv.nbytes
        rc = self._lib.srq_put(self._addr, iov, n, float(timeout))
        if rc == -1:
            raise TimeoutError("ShmRing.put timeout")
        if rc == -2:
            total = sum(memoryview(p).nbytes for p in parts)
            raise ValueError(
                f"message {total}B exceeds slot {self.slot_bytes}B — raise "
                f"DataLoader.native_slot_bytes")
        if rc == -3:
            raise BrokenPipeError("ShmRing closed")

    def get(self, timeout: float = 60.0) -> Optional[bytearray]:
        """One message (a writable bytearray); None once closed and
        drained."""
        buf = self._scratch
        caddr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
        rc = self._lib.srq_get(self._addr, caddr, len(buf), float(timeout))
        if rc == -1:
            raise TimeoutError("ShmRing.get timeout")
        if rc == -2:
            raise ValueError("message larger than slot?")
        if rc == -3:
            return None
        # a copy the arrays can view writably, as the queue's arrays are
        return bytearray(buf[: int(rc)])

    def close(self) -> None:
        self._lib.srq_close(self._addr)

    def count(self) -> int:
        return int(self._lib.srq_count(self._addr))


# -- batch codec -------------------------------------------------------------
def _flatten(tree, leaves: list):
    """The nesting of ``tree`` (dicts, lists, tuples) with each leaf
    replaced by its index in ``leaves``."""
    if isinstance(tree, dict):
        return ("dict", type(tree), [(k, _flatten(v, leaves))
                                     for k, v in tree.items()])
    if isinstance(tree, (list, tuple)):
        return ("seq", type(tree), [_flatten(v, leaves) for v in tree])
    leaves.append(tree)
    return ("leaf", len(leaves) - 1)


def _unflatten(spec, leaves: list):
    if spec[0] == "leaf":
        return leaves[spec[1]]
    kind, cls, items = spec
    if kind == "dict":
        return cls((k, _unflatten(v, leaves)) for k, v in items)
    return cls(_unflatten(v, leaves) for v in items)


def encode_batch_parts(bid: int, batch, err: Optional[str] = None
                       ) -> List[Any]:
    """``[u32 meta_len][meta pickle][array payloads...]`` as iovec parts."""
    leaves: list = []
    spec = _flatten(batch, leaves)
    # np.asarray keeps a 0-d leaf 0-d (np.ascontiguousarray alone would
    # make it 1-d); a strided array is copied contiguous
    arrays = [np.asarray(a) for a in leaves]
    arrays = [a if a.flags.c_contiguous else np.ascontiguousarray(a)
              for a in arrays]
    meta = pickle.dumps(
        (bid, err, spec, [(a.dtype.str, a.shape) for a in arrays]))
    parts: List[Any] = [struct.pack("<I", len(meta)), meta]
    parts.extend(arrays)
    return parts


def decode_batch(msg: bytes) -> Tuple[int, Optional[str], Any]:
    (meta_len,) = struct.unpack_from("<I", msg, 0)
    bid, err, spec, specs = pickle.loads(msg[4: 4 + meta_len])
    off = 4 + meta_len
    leaves = []
    for dtype, shape in specs:
        count = int(np.prod(shape))
        leaves.append(np.frombuffer(msg, dtype=dtype, count=count,
                                    offset=off).reshape(shape))
        off += count * np.dtype(dtype).itemsize
    return bid, err, _unflatten(spec, leaves)
