"""Tree fingerprints: the port of ``paddle_tpu/distributed/fingerprint.py``,
the ``mlh32/1`` digest that a checkpoint stamps into its manifest and
re-checks on load.

The digest is a chunked multilinear hash mod 2**32 over each leaf's bits:

    leaf(x)  = sum_j V[j] * (sum_k u32(x)[j*C + k] * W[k])      (mod 2**32)
    tree     = sum_leaf nameweight(name) * leaf(x)             (mod 2**32)

with ``C = CHUNK`` lanes a chunk, ``W`` a fixed vector of odd weights,
``V[j] = (j * 2654435761 + 0x9E3779B9) | 1`` and ``nameweight`` the odd
FNV-1a of the leaf's name.  Odd weights make any single flipped bit change
the digest; zero lanes add nothing, so trailing zero padding leaves it as
it is.  Leaves whose name has a rank-private part (``DEFAULT_EXCLUDE``) are
left out and listed in ``Fingerprint.excluded``.

Two implementations, which agree bit for bit with each other and with the
JAX package's on the same trees (tested): :class:`TreeFingerprint` on the
tensors' own device (int64 torch arithmetic kept below 2**63 and reduced
mod 2**32; one scalar readback for the tree digest) and
:func:`digest_tree_host` in numpy.  The lanes are each element's bits:
32-bit dtypes as one u32 lane, 8-byte dtypes as two (low word first),
16-bit dtypes (bfloat16 through its bit pattern, with no ``ml_dtypes``
needed) and 8-bit ones zero-extended.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["TreeFingerprint", "Fingerprint", "digest_tree_host",
           "tree_digest", "leaf_name_weight", "is_rank_private",
           "DEFAULT_EXCLUDE", "CHUNK", "DIGEST_ALGO"]

#: lanes per chunk
CHUNK = 4096

#: the algorithm tag stamped into checkpoint manifests; digests compare
#: only under equal tags
DIGEST_ALGO = "mlh32/1"

#: rank-private name parts left out of the digest (the error-feedback
#: residuals of the JAX package's compressed all-reduce)
DEFAULT_EXCLUDE: Tuple[str, ...] = ("resid", "ef_residual")

_MOD = np.uint64(1) << np.uint64(32)
_M32 = 0xFFFFFFFF
# a fixed seed: digests are stable across processes, hosts and packages
_W_HOST = (np.random.RandomState(0x17D1)
           .randint(0, 2**32, size=CHUNK, dtype=np.uint64)
           .astype(np.uint32) | np.uint32(1))
_CHUNK_MUL = 2654435761       # Knuth's multiplicative constant
_CHUNK_ADD = 0x9E3779B9       # the golden-ratio offset


def leaf_name_weight(name: str) -> int:
    """Odd 32-bit FNV-1a of the leaf name: the tree-level weight, so one
    value under two names hashes apart."""
    h = 2166136261
    for b in name.encode("utf-8"):
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h | 1


def is_rank_private(name: str, exclude: Sequence[str] = DEFAULT_EXCLUDE
                    ) -> bool:
    parts = name.split("/")
    return any(k in parts for k in exclude)


def _flatten_named(tree) -> List[Tuple[str, Any]]:
    # the checkpoint's "/"-joined names, so digests and manifests speak of
    # the same leaves
    from .checkpoint import _flatten
    return _flatten(tree)


# ---------------------------------------------------------------------------
# lanes: each element's bits as u32 values
# ---------------------------------------------------------------------------
def _lanes_np(x) -> np.ndarray:
    from .checkpoint import _host_array
    x = np.ascontiguousarray(_host_array(x)[0])
    if x.dtype == np.bool_:
        x = x.astype(np.uint8)
    size = x.dtype.itemsize
    flat = x.reshape(-1)
    if size >= 4:
        return flat.view(np.uint32)
    if size == 2:
        return flat.view(np.uint16).astype(np.uint32)
    return flat.view(np.uint8).astype(np.uint32)


def _lanes_torch(x: torch.Tensor) -> torch.Tensor:
    """int64 lanes in [0, 2**32) on the tensor's device."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    flat = x.detach().contiguous().reshape(-1)
    size = flat.element_size()
    if size >= 4:
        return flat.view(torch.int32).to(torch.int64) & _M32
    if size == 2:
        return flat.view(torch.int16).to(torch.int64) & 0xFFFF
    return flat.view(torch.uint8).to(torch.int64)


def _mulmod32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2**32`` for int64 values in [0, 2**32), with every
    intermediate below 2**49 (no int64 overflow)."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _leaf_digest_np(x) -> int:
    lanes = _lanes_np(x)
    n = lanes.size
    if n == 0:
        return 0
    pad = (-n) % CHUNK
    if pad:
        lanes = np.concatenate([lanes, np.zeros(pad, np.uint32)])
    rows = lanes.reshape(-1, CHUNK)
    rowsums = np.einsum("jk,k->j", rows.astype(np.uint64),
                        _W_HOST.astype(np.uint64)) % _MOD
    j = np.arange(rows.shape[0], dtype=np.uint64)
    v = (j * np.uint64(_CHUNK_MUL) + np.uint64(_CHUNK_ADD)) % _MOD | \
        np.uint64(1)
    return int((rowsums * v % _MOD).sum() % _MOD)


def _leaf_digest_torch(x: torch.Tensor) -> torch.Tensor:
    """The leaf digest as an int64 scalar on ``x``'s device."""
    lanes = _lanes_torch(x)
    n = lanes.numel()
    if n == 0:
        return torch.zeros((), dtype=torch.int64, device=x.device)
    pad = (-n) % CHUNK
    if pad:
        lanes = torch.cat([lanes, lanes.new_zeros(pad)])
    rows = lanes.reshape(-1, CHUNK)
    w = torch.from_numpy(_W_HOST.astype(np.int64)).to(x.device)
    rowsums = _mulmod32(rows, w[None, :]).sum(dim=1) & _M32
    j = torch.arange(rows.shape[0], dtype=torch.int64, device=x.device)
    v = ((j * _CHUNK_MUL + _CHUNK_ADD) & _M32) | 1
    return _mulmod32(rowsums, v).sum() & _M32


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------
class Fingerprint:
    """One digest pass over a tree.  ``tree`` is the digest (reading it
    from a device pass waits for the card); :meth:`leaf_digests` gives the
    per-leaf digests, for attribution."""

    def __init__(self, names: List[str], excluded: List[str],
                 tree_digest, leaf_digests):
        self.names = list(names)
        self.excluded = list(excluded)
        self._tree = tree_digest
        self._leaves = leaf_digests

    @property
    def tree(self) -> int:
        return int(self._tree)

    def hex(self) -> str:
        return f"{self.tree:08x}"

    def leaf_digests(self) -> Dict[str, int]:
        vals = self._leaves
        if torch.is_tensor(vals):
            vals = vals.cpu().numpy()
        return {n: int(v) for n, v in zip(self.names, np.asarray(vals))}

    def diff(self, other: "Fingerprint") -> List[str]:
        """Names of the leaves whose digests differ."""
        mine, theirs = self.leaf_digests(), other.leaf_digests()
        return sorted(n for n in mine if theirs.get(n, None) != mine[n])

    def meta(self, with_leaves: bool = True) -> Dict[str, Any]:
        """The JSON-ready manifest stamp (``checkpoint.save_sharded``)."""
        out: Dict[str, Any] = {"algo": DIGEST_ALGO, "tree": self.hex(),
                               "excluded": self.excluded}
        if with_leaves:
            out["leaves"] = {n: f"{d:08x}"
                             for n, d in self.leaf_digests().items()}
        return out

    def __repr__(self) -> str:
        return (f"Fingerprint(tree={self.hex()}, leaves={len(self.names)},"
                f" excluded={len(self.excluded)})")


def _split(tree, exclude: Sequence[str]):
    named = _flatten_named(tree)
    excluded = sorted(n for n, _ in named if is_rank_private(n, exclude))
    included = sorted(((n, x) for n, x in named
                       if not is_rank_private(n, exclude)),
                      key=lambda nx: nx[0])
    return included, excluded


class TreeFingerprint:
    """The digest computed on the tensors' device:

    >>> fp = TreeFingerprint()
    >>> fp.digest(state).hex()     # device work, one scalar readback
    '9f2a44c1'

    Leaves that are not tensors (numpy arrays, Python scalars) are hashed
    on the host, as the checkpoint stores them."""

    def __init__(self, exclude: Sequence[str] = DEFAULT_EXCLUDE):
        self.exclude = tuple(exclude)

    def digest(self, tree) -> Fingerprint:
        included, excluded = _split(tree, self.exclude)
        names = [n for n, _ in included]
        if not included:
            return Fingerprint(names, excluded, 0, np.zeros(0, np.uint32))
        dev = next((x.device for _, x in included if torch.is_tensor(x)),
                   torch.device("cpu"))
        leaves = [_leaf_digest_torch(x).to(dev) if torch.is_tensor(x)
                  else torch.tensor(_leaf_digest_np(x), dtype=torch.int64,
                                    device=dev)
                  for _, x in included]
        per_leaf = torch.stack(leaves)
        w = torch.tensor([leaf_name_weight(n) for n in names],
                         dtype=torch.int64, device=dev)
        tree_d = _mulmod32(per_leaf, w).sum() & _M32
        return Fingerprint(names, excluded, tree_d, per_leaf)


def digest_tree_host(tree, exclude: Sequence[str] = DEFAULT_EXCLUDE
                     ) -> Fingerprint:
    """The numpy digest, bit-identical to :meth:`TreeFingerprint.digest`,
    for trees on the host (a restored checkpoint)."""
    included, excluded = _split(tree, exclude)
    names = [n for n, _ in included]
    leaf_d = np.array([_leaf_digest_np(x) for _, x in included],
                      dtype=np.uint32)
    w = np.array([leaf_name_weight(n) for n in names], dtype=np.uint64)
    tree_d = int((leaf_d.astype(np.uint64) * w % _MOD).sum() % _MOD)
    return Fingerprint(names, excluded, tree_d, leaf_d)


def tree_digest(tree, exclude: Sequence[str] = DEFAULT_EXCLUDE) -> int:
    """The tree digest as an int (host path)."""
    return digest_tree_host(tree, exclude).tree
