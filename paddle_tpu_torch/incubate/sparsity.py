"""ASP, automatic n:m structured sparsity: the port of
``paddle_tpu/incubate/sparsity.py`` (reference
python/paddle/fluid/contrib/sparsity/{asp.py,utils.py}: ``decorate``,
``prune_model``, the mask algorithms ``get_mask_1d``,
``get_mask_2d_greedy``, ``get_mask_2d_best`` and their checkers).

The masks are computed on the host in numpy, the JAX module's algorithm
line for line, so they are bit-identical with it; ``prune_model``
multiplies them into the parameters in place and registers them by
parameter name, and the optimizer of :func:`decorate` multiplies the
registered masks back in after every ``step()`` so momentum and weight
decay cannot densify the pattern.  The 2:4 pattern is the one Hopper's
sparse tensor cores take; this port prunes and keeps the pattern, and its
products stay dense.
"""
from __future__ import annotations

import itertools
from enum import Enum
from typing import Dict, List, Optional

import numpy as np
import torch

from ..framework.errors import enforce

__all__ = [
    "MaskAlgo", "CheckMethod", "calculate_density", "get_mask_1d",
    "get_mask_2d_greedy", "get_mask_2d_best", "check_mask_1d",
    "check_mask_2d", "create_mask", "check_sparsity", "decorate",
    "prune_model", "set_excluded_layers", "reset_excluded_layers",
    "reset_masks",
]


class MaskAlgo(Enum):
    MASK_1D = "get_mask_1d"
    MASK_2D_GREEDY = "get_mask_2d_greedy"
    MASK_2D_BEST = "get_mask_2d_best"


class CheckMethod(Enum):
    CHECK_1D = "check_mask_1d"
    CHECK_2D = "check_mask_2d"

    @staticmethod
    def get_checking_method(mask_algo: MaskAlgo) -> "CheckMethod":
        return (CheckMethod.CHECK_1D if mask_algo == MaskAlgo.MASK_1D
                else CheckMethod.CHECK_2D)


def _np(x) -> np.ndarray:
    """A host array of ``x`` (a tensor on any device, bf16 / fp16 as
    float32)."""
    return _host(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def calculate_density(x) -> float:
    """Fraction of nonzeros (reference utils.py:87)."""
    a = _np(x)
    return float(np.count_nonzero(a)) / a.size


# -- mask algorithms (host numpy; masks are offline artifacts) -------------
def _pad_cols(mat: np.ndarray, m: int) -> np.ndarray:
    pad = (-mat.shape[1]) % m
    if pad:
        mat = np.concatenate(
            [mat, np.zeros((mat.shape[0], pad), mat.dtype)], axis=1)
    return mat


def get_mask_1d(mat, n: int, m: int) -> np.ndarray:
    """Zero the n smallest-magnitude entries of every m consecutive values
    along each row (reference utils.py:181; n:m is "at least n zeros per
    1 x m block", so 2:4 keeps the 2 largest of every 4)."""
    mat = np.asarray(mat)
    h, w = mat.shape
    padded = _pad_cols(np.abs(mat), m).reshape(-1, m)
    drop = np.argsort(padded, axis=1)[:, :n]
    mask = np.ones_like(padded)
    np.put_along_axis(mask, drop, 0.0, axis=1)
    return mask.reshape(h, -1)[:, :w]


def get_mask_2d_greedy(mat, n: int, m: int) -> np.ndarray:
    """Greedy m x m tile pruning: keep entries in descending magnitude,
    leaving at least n zeros per row AND per column of the tile
    (utils.py:314)."""
    mat = np.asarray(mat)
    h, w = mat.shape
    ph, pw = -h % m, -w % m
    a = np.abs(np.pad(mat, ((0, ph), (0, pw))))
    keep = m - n                      # n zeros per row/col => m-n kept
    mask = np.zeros_like(a)
    for bi in range(0, a.shape[0], m):
        for bj in range(0, a.shape[1], m):
            tile = a[bi:bi + m, bj:bj + m]
            order = np.dstack(np.unravel_index(
                np.argsort(-tile, axis=None), (m, m)))[0]
            rows = np.zeros(m, np.int64)
            cols = np.zeros(m, np.int64)
            for r, c in order:
                if rows[r] < keep and cols[c] < keep:
                    mask[bi + r, bj + c] = 1.0
                    rows[r] += 1
                    cols[c] += 1
    return mask[:h, :w]


def _valid_2d_patterns(n: int, m: int) -> np.ndarray:
    """All m x m binary patterns with exactly m-n ones per row and column
    — i.e. n zeros per row and column (utils.py:384)."""
    keep = m - n
    rows = [np.array(p) for p in itertools.combinations(range(m), keep)]
    row_vecs = []
    for p in rows:
        v = np.zeros(m)
        v[list(p)] = 1.0
        row_vecs.append(v)
    patterns = []
    for combo in itertools.product(range(len(row_vecs)), repeat=m):
        pat = np.stack([row_vecs[i] for i in combo])
        if (pat.sum(0) == keep).all():
            patterns.append(pat)
    return np.stack(patterns)


_PATTERN_CACHE: Dict[tuple, np.ndarray] = {}


def get_mask_2d_best(mat, n: int, m: int) -> np.ndarray:
    """Exhaustive-pattern m x m tile pruning: per tile, the valid pattern
    maximizing retained magnitude (utils.py:422)."""
    mat = np.asarray(mat)
    key = (n, m)
    if key not in _PATTERN_CACHE:
        _PATTERN_CACHE[key] = _valid_2d_patterns(n, m)
    patterns = _PATTERN_CACHE[key]                  # (P, m, m)
    h, w = mat.shape
    ph, pw = -h % m, -w % m
    a = np.abs(np.pad(mat, ((0, ph), (0, pw))))
    H, W = a.shape
    tiles = a.reshape(H // m, m, W // m, m).transpose(0, 2, 1, 3)
    scores = np.einsum("ijxy,pxy->ijp", tiles, patterns)
    best = patterns[np.argmax(scores, axis=-1)]     # (H/m, W/m, m, m)
    mask = best.transpose(0, 2, 1, 3).reshape(H, W)
    return mask[:h, :w]


def check_mask_1d(mat, n: int, m: int) -> bool:
    """Every m consecutive row-entries hold at least n zeros — i.e.
    <= (m - n) nonzeros (utils.py:137)."""
    mat = np.asarray(mat)
    groups = _pad_cols((mat != 0).astype(np.float64), m).reshape(-1, m)
    return bool((groups.sum(1) <= m - n).all())


def check_mask_2d(mat, n: int, m: int) -> bool:
    """At least n zeros per row AND per column of every m x m tile — i.e.
    <= (m - n) nonzeros each way (utils.py:264; this is the documented
    condition, applied strictly to both axes)."""
    mat = np.asarray(mat)
    h, w = mat.shape
    nz = (np.pad(mat, ((0, -h % m), (0, -w % m))) != 0).astype(np.float64)
    H, W = nz.shape
    tiles = nz.reshape(H // m, m, W // m, m).transpose(0, 2, 1, 3)
    keep = m - n
    return bool((tiles.sum(3) <= keep).all() and (tiles.sum(2) <= keep).all())


def _as_2d(t: np.ndarray) -> np.ndarray:
    """Weight view the masks act on: 2-D as-is; conv kernels (O, I, H, W)
    flatten to (O, I*H*W) — the reference's supported-layer reshape."""
    if t.ndim == 2:
        return t
    return t.reshape(t.shape[0], -1)


def create_mask(tensor, func_name: MaskAlgo = MaskAlgo.MASK_1D,
                n: int = 2, m: int = 4) -> np.ndarray:
    """n:m mask for a parameter tensor (utils.py:475)."""
    t = _np(tensor)
    enforce(t.ndim >= 2, f"ASP supports >=2-D weights, got shape {t.shape}")
    fn = globals()[MaskAlgo(func_name).value]
    mask2d = fn(_as_2d(t), n, m)
    return mask2d.reshape(t.shape).astype(t.dtype)


def check_sparsity(tensor, func_name: CheckMethod = CheckMethod.CHECK_1D,
                   n: int = 2, m: int = 4) -> bool:
    t = _np(tensor)
    fn = globals()[CheckMethod(func_name).value]
    return fn(_as_2d(t), n, m)


# -- model-level API -------------------------------------------------------
_EXCLUDED: List[str] = []
_MASKS: Dict[str, torch.Tensor] = {}


def set_excluded_layers(param_names, main_program=None) -> None:
    """Exclude parameters (by exact ``state_dict`` name or dotted prefix)
    from pruning (asp.py:38; ``main_program`` is accepted for the
    signature: there is one program here)."""
    _EXCLUDED.extend(param_names)


def reset_excluded_layers(main_program=None) -> None:
    _EXCLUDED.clear()


def reset_masks() -> None:
    """Clear the registered masks.  Call between pruning different models
    in one process: masks are keyed by parameter name, and two models
    easily share names like "0.weight"."""
    _MASKS.clear()


def _supported(name: str, value) -> bool:
    if getattr(value, "ndim", 0) < 2:
        return False                       # biases, norms
    # the exact name or a dotted prefix only: a substring match would make
    # "0.weight" also exclude "10.weight"
    return not any(name == ex or name.startswith(ex + ".")
                   for ex in _EXCLUDED)


def _host(p: torch.Tensor) -> np.ndarray:
    """The parameter as a host array (bf16 / fp16 as float32: their
    magnitudes, hence the masks, are unchanged)."""
    t = p.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


@torch.no_grad()
def prune_model(model, n: int = 2, m: int = 4,
                mask_algo: str = "mask_1d",
                with_mask: bool = True) -> Dict[str, np.ndarray]:
    """Prune every supported weight of ``model`` to the n:m pattern in
    place and (``with_mask``) register its mask so a decorated optimizer
    keeps the pattern through training (asp.py:156).  Returns the host
    masks by parameter name."""
    algo = {"mask_1d": MaskAlgo.MASK_1D,
            "mask_2d_greedy": MaskAlgo.MASK_2D_GREEDY,
            "mask_2d_best": MaskAlgo.MASK_2D_BEST}[mask_algo]
    masks: Dict[str, np.ndarray] = {}
    for name, p in model.named_parameters():
        if not _supported(name, p):
            continue
        mask = create_mask(_host(p), algo, n, m)
        dev_mask = torch.from_numpy(mask).to(device=p.device, dtype=p.dtype)
        p.mul_(dev_mask)
        masks[name] = mask
        if with_mask:
            _MASKS[name] = dev_mask
    return masks


class OptimizerWithSparsityGuarantee:
    """A port optimizer whose every ``step()`` ends by multiplying the
    registered masks back into their parameters (asp.py:571), matched by
    the optimizer's parameter names."""

    def __init__(self, optimizer):
        self._inner = optimizer

    def __getattr__(self, item):
        return getattr(self._inner, item)

    @torch.no_grad()
    def step(self, *args, **kwargs):
        out = self._inner.step(*args, **kwargs)
        if _MASKS:
            for name, p in zip(self._inner._names, self._inner._params):
                mask = _MASKS.get(name)
                if mask is not None:
                    p.mul_(mask.to(p.dtype))
        return out


def decorate(optimizer) -> OptimizerWithSparsityGuarantee:
    """asp.py:117: the sparsity-keeping wrapper of ``optimizer``."""
    return OptimizerWithSparsityGuarantee(optimizer)
