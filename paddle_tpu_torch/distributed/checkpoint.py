"""Sharded checkpoints: the port of ``paddle_tpu/distributed/checkpoint.py``
for one process, in the JAX package's on-disk format, so a checkpoint
written by either package loads in the other.

A state is a tree of dicts, lists and tuples whose leaves are tensors,
numpy arrays or Python scalars (a None is an empty subtree, as in JAX).
Each leaf is one ``.npy`` shard file under ``<path>/<name with "/" as
"__">/shard-p0-0.npy``, with its window ``[[0, dim], ...]``; bfloat16 is
stored as its ``uint16`` bits under dtype ``"bfloat16"``; Python ints,
floats and bools are stored as int32, float32 and bool, as JAX's
``jnp.asarray`` makes them.  ``manifest-p0.json`` (manifest v2: shapes,
dtypes, every shard's window, CRC32 and byte size, and the ``integrity``
stamp) is written last, so a reader that sees a manifest can verify every
byte it names.  Every write is fsync'd through ``utils/fsio`` under the
retry policy of ``utils/retry``; a corrupt checkpoint is never retried.

``load_sharded`` verifies every shard (existence, size, CRC32) before it
reads one, and re-hashes the restored tree against the manifest's
``mlh32/1`` stamp (``distributed/fingerprint.py``).  The device-to-host
copy of ``save_sharded(use_async=True)`` happens before it returns; only
the writes run on the thread, and ``AsyncSaveHandle.wait()`` raises the
thread's error.
"""
from __future__ import annotations

import io as _io
import json
import os
import threading
import warnings
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..framework.errors import enforce
from ..framework.log import vlog
from ..utils import fsio
from ..utils.retry import RetryPolicy, retry_call

__all__ = ["save_sharded", "load_sharded", "verify_sharded",
           "AsyncSaveHandle", "CheckpointCorruption", "DigestMismatch",
           "read_integrity"]

_MANIFEST = "manifest.json"          # the legacy single-host name (read)
_MANIFEST_P0 = "manifest-p0.json"    # this process's (process 0's)
MANIFEST_VERSION = 2                 # v2: per-shard crc32 and byte size

#: the retry schedule of checkpoint file I/O (module level, so a test can
#: swap in one that does not sleep)
IO_RETRY_POLICY = RetryPolicy(max_attempts=4, base_delay=0.05)


class CheckpointCorruption(OSError):
    """A checkpoint failed verification (a missing shard file, a size or a
    CRC32 that differs from the manifest, an unreadable manifest).  Not
    retryable: the bytes on disk are wrong and stay wrong."""


class DigestMismatch(CheckpointCorruption):
    """The restored tree's fingerprint differs from the stamp the manifest
    took at save time: the state changed between hashing and writing, or
    the restore mangled it (shard CRCs cover only the bytes on disk)."""


# ---------------------------------------------------------------------------
# trees and leaves
# ---------------------------------------------------------------------------
def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs in JAX's order: dict keys sorted, sequence
    items by index, names joined by "/"; None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host numpy array and its manifest dtype name; bfloat16
    (a torch tensor, or a numpy array of the ``bfloat16`` extension type)
    comes back as its uint16 bits."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.cpu().view(torch.int16).numpy().view(np.uint16), \
                "bfloat16"
        arr = t.cpu().numpy()
        return arr, str(arr.dtype)
    if isinstance(leaf, bool):
        arr = np.asarray(leaf, np.bool_)
    elif isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)
    elif isinstance(leaf, float):
        arr = np.asarray(leaf, np.float32)
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _leaf_dir(path: str, name: str) -> str:
    return os.path.join(path, name.replace("/", "__"))


class AsyncSaveHandle:
    """Returned by ``save_sharded(use_async=True)``: ``wait()`` blocks
    until every shard and the manifest are durably on disk and raises the
    writer thread's error, if it had one."""

    def __init__(self, thread: threading.Thread, errors: list):
        self._thread = thread
        self._errors = errors

    def wait(self) -> None:
        self._thread.join()
        if self._errors:
            raise self._errors[0]

    def done(self) -> bool:
        return not self._thread.is_alive()


def save_sharded(state, path: str, *, use_async: bool = False,
                 integrity: Optional[Dict[str, Any]] = None
                 ) -> Optional[AsyncSaveHandle]:
    """Write ``state`` as a checkpoint under ``path`` (one process: each
    leaf is one shard).  ``integrity``: a JSON-ready fingerprint stamp
    (``Fingerprint.meta()`` plus the ``exclude`` it used) recorded in the
    manifest, which ``load_sharded`` re-checks."""
    os.makedirs(path, exist_ok=True)
    manifest: Dict[str, Any] = {"version": MANIFEST_VERSION, "world": 1,
                                "leaves": {}}
    if integrity is not None:
        manifest["integrity"] = dict(integrity)
    work: List[Tuple[str, Dict[str, Any], np.ndarray]] = []
    for name, leaf in _flatten(state):
        # the device -> host copy happens now: the caller may change the
        # tensors as soon as this returns (a host leaf is copied too)
        data, dtype = _host_array(leaf)
        if not (torch.is_tensor(leaf) and leaf.device.type != "cpu"):
            data = data.copy()
        meta = {"file": "shard-p0-0.npy",
                "index": [[0, int(d)] for d in data.shape]}
        manifest["leaves"][name] = {"shape": list(data.shape),
                                    "dtype": dtype, "shards": [meta]}
        work.append((name, meta, data))

    def _write():
        for name, meta, data in work:
            d = _leaf_dir(path, name)
            os.makedirs(d, exist_ok=True)
            buf = _io.BytesIO()
            np.save(buf, data)
            payload = buf.getvalue()
            # the checksum of the exact bytes on disk, header included
            meta["crc32"] = zlib.crc32(payload) & 0xFFFFFFFF
            meta["bytes"] = len(payload)
            retry_call(fsio.write_bytes, os.path.join(d, meta["file"]),
                       payload, policy=IO_RETRY_POLICY)
            fsio.fsync_dir(d)
        retry_call(fsio.write_bytes, os.path.join(path, _MANIFEST_P0),
                   json.dumps(manifest, indent=1).encode("utf-8"),
                   policy=IO_RETRY_POLICY)
        fsio.fsync_dir(path)

    if not use_async:
        _write()
        return None
    errors: list = []

    def _run():
        try:
            _write()
        except Exception as e:  # raised again by AsyncSaveHandle.wait()
            errors.append(e)

    t = threading.Thread(target=_run, daemon=True)
    t.start()
    return AsyncSaveHandle(t, errors)


def _read_manifests(path: str) -> Tuple[int, Dict[str, Any],
                                        Optional[Dict[str, Any]]]:
    """Every process's manifest merged: ``(version, leaves, integrity)``."""
    p0 = os.path.join(path, _MANIFEST_P0)
    if not os.path.exists(p0) and os.path.exists(
            os.path.join(path, _MANIFEST)):
        p0 = os.path.join(path, _MANIFEST)
    enforce(os.path.exists(p0), f"no manifest found under {path!r}")

    def _load_json(mpath):
        try:
            return json.loads(retry_call(fsio.read_bytes, mpath,
                                         policy=IO_RETRY_POLICY))
        except json.JSONDecodeError as e:
            raise CheckpointCorruption(
                f"manifest {mpath} unreadable: {e}") from e

    head = _load_json(p0)
    version = int(head.get("version", 1))
    world = int(head.get("world", 1))
    names = [p0] + [os.path.join(path, f"manifest-p{i}.json")
                    for i in range(1, world)]
    missing = [n for n in names if not os.path.exists(n)]
    if missing:
        raise CheckpointCorruption(
            f"checkpoint written by {world} processes but manifests "
            f"missing: {missing}")
    leaves: Dict[str, Any] = {}
    for mpath in names:
        part = head if mpath == p0 else _load_json(mpath)
        for lname, entry in part["leaves"].items():
            if lname in leaves:
                leaves[lname]["shards"].extend(entry["shards"])
            else:
                leaves[lname] = entry
    return version, leaves, head.get("integrity")


def read_integrity(path: str) -> Optional[Dict[str, Any]]:
    """The fingerprint stamp of a checkpoint's head manifest, or None."""
    return _read_manifests(path)[2]


def verify_sharded(path: str) -> List[str]:
    """Problems of every shard file the manifests name (empty: clean):
    existence, and with a v2 manifest byte size and CRC32."""
    _, leaves, _ = _read_manifests(path)
    problems: List[str] = []
    for name, entry in leaves.items():
        d = _leaf_dir(path, name)
        for shard in entry["shards"]:
            fpath = os.path.join(d, shard["file"])
            rel = os.path.join(os.path.basename(d), shard["file"])
            if not os.path.exists(fpath):
                problems.append(f"{rel}: missing")
                continue
            if "bytes" in shard:
                size = os.path.getsize(fpath)
                if size != int(shard["bytes"]):
                    problems.append(
                        f"{rel}: size {size} != recorded {shard['bytes']}")
                    continue
            if "crc32" in shard:
                crc = zlib.crc32(retry_call(
                    fsio.read_bytes, fpath,
                    policy=IO_RETRY_POLICY)) & 0xFFFFFFFF
                if crc != int(shard["crc32"]):
                    problems.append(
                        f"{rel}: crc32 {crc:#010x} != recorded "
                        f"{int(shard['crc32']):#010x}")
    return problems


def _read_leaf(leaf_dir: str, entry: Dict[str, Any]) -> torch.Tensor:
    """One leaf, stitched from its shard files, as a CPU tensor."""
    shape = [int(d) for d in entry["shape"]]
    bf16 = entry["dtype"] == "bfloat16"
    out = np.empty(shape, np.uint16 if bf16 else np.dtype(entry["dtype"]))
    filled = 0
    for shard in entry["shards"]:
        data = np.load(os.path.join(leaf_dir, shard["file"]))
        window = tuple(slice(a, b) for a, b in shard["index"])
        out[window] = data
        filled += data.size
    enforce(filled == out.size,
            f"checkpoint leaf {leaf_dir} only {filled}/{out.size} covered")
    t = torch.from_numpy(out)
    return t.view(torch.int16).view(torch.bfloat16) if bf16 else t


def _verify_digest(path: str, restored, meta: Optional[Dict[str, Any]],
                   strict: bool) -> None:
    """Re-hash a restored tree against the manifest's stamp: raises
    :class:`DigestMismatch` (``strict=False``: a warning)."""
    if not meta:
        return
    from .fingerprint import DEFAULT_EXCLUDE, DIGEST_ALGO, digest_tree_host
    if meta.get("algo") != DIGEST_ALGO:
        warnings.warn(
            f"checkpoint {path!r} stamped with unknown digest algo "
            f"{meta.get('algo')!r}; fingerprint verification skipped",
            RuntimeWarning, stacklevel=3)
        return
    got = digest_tree_host(restored,
                           tuple(meta.get("exclude", DEFAULT_EXCLUDE)))
    want = str(meta.get("tree"))
    if got.hex() == want:
        vlog(1, "checkpoint: %s tree digest %s verified", path, want)
        return
    stamped = meta.get("leaves") or {}
    mine = got.leaf_digests()
    bad = sorted(n for n, h in stamped.items()
                 if n in mine and f"{mine[n]:08x}" != h)
    msg = (f"checkpoint {path!r} restored tree digest {got.hex()} != "
           f"stamped {want}"
           + (f" (leaves differing: {bad[:5]})" if bad else ""))
    if strict:
        raise DigestMismatch(msg)
    warnings.warn(msg + " - loading anyway (strict=False)", RuntimeWarning,
                  stacklevel=3)


def load_sharded(path: str, template=None, *, strict: bool = True,
                 verify_digest: bool = True):
    """Load a checkpoint.

    ``template=None``: a nested dict (names split on "/") of CPU tensors,
    bfloat16 leaves as ``torch.bfloat16``.  With a ``template`` (a tree
    whose leaves are tensors): the same tree, each leaf in its saved dtype
    on the template leaf's device; shapes must agree, and every template
    leaf must be in the checkpoint.

    With a v2 manifest every shard is verified before anything is read
    (:class:`CheckpointCorruption`; ``strict=False`` warns and loads what
    it can), and a stamped checkpoint's restored tree is re-hashed
    (:class:`DigestMismatch`; ``verify_digest=False`` skips it)."""
    version, leaves, integrity = _read_manifests(path)
    if not verify_digest:
        integrity = None
    if version < 2:
        warnings.warn(
            f"checkpoint {path!r} has a v{version} manifest (no checksums); "
            "integrity verification skipped", RuntimeWarning, stacklevel=2)
    else:
        problems = verify_sharded(path)
        if problems:
            msg = (f"checkpoint {path!r} failed verification "
                   f"({len(problems)} problem(s)): "
                   + "; ".join(problems[:5])
                   + (" ..." if len(problems) > 5 else ""))
            if strict:
                raise CheckpointCorruption(msg)
            warnings.warn(msg + " - loading anyway (strict=False)",
                          RuntimeWarning, stacklevel=2)

    if template is None:
        out: Dict[str, Any] = {}
        for name, entry in leaves.items():
            node = out
            parts = name.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = _read_leaf(_leaf_dir(path, name), entry)
        _verify_digest(path, out, integrity, strict)
        return out

    tpl = _flatten(template)
    missing = sorted({n for n, _ in tpl} - set(leaves))
    enforce(not missing, f"checkpoint missing leaves: {missing[:5]}")
    restored = {}
    for name, t in tpl:
        entry = leaves[name]
        shape = tuple(entry["shape"])
        enforce(tuple(t.shape) == shape,
                f"{name}: template shape {tuple(t.shape)} != saved {shape}")
        restored[name] = _read_leaf(_leaf_dir(path, name), entry).to(
            t.device)
    _verify_digest(path, {n: restored[n] for n, _ in tpl}, integrity,
                   strict)
    return _unflatten(template, restored)


def _unflatten(template, leaves: Dict[str, Any], prefix: str = ""):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves,
                              f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten(v, leaves, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(template))
    return leaves[prefix]
