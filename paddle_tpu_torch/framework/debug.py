"""nan/inf debugging: the port of ``paddle_tpu/framework/debug.py`` (the
reference's ``FLAGS_check_nan_inf`` scan, operator.cc:1252).

``finite_flags`` reduces every floating leaf of a tree to one boolean on
its device; ``assert_all_finite`` reads the flags on the host and raises
naming each offending leaf: one host read per check, not one per op.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..utils.tree import tree_map_with_path
from .flags import get_flag

__all__ = ["check_nan_inf_enabled", "finite_flags", "assert_all_finite"]


def check_nan_inf_enabled() -> bool:
    v = get_flag("check_nan_inf")
    return bool(v) and str(v) not in ("0", "False", "false")


def finite_flags(tree) -> Dict[str, Any]:
    """{leaf path: 0-d bool tensor (all finite)} for every floating leaf."""
    out = {}

    def visit(path, leaf):
        x = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
        if x.is_floating_point() or x.is_complex():
            out[path] = torch.isfinite(x).all()
        return leaf
    tree_map_with_path(visit, tree)
    return out


def assert_all_finite(flags: Dict[str, Any], context: str = "") -> None:
    """Host-side: raise listing every non-finite leaf."""
    bad = [name for name, ok in flags.items() if not bool(ok)]
    if bad:
        where = f" in {context}" if context else ""
        raise FloatingPointError(
            f"nan/inf detected{where}: {', '.join(sorted(bad)[:10])}"
            + (f" (+{len(bad) - 10} more)" if len(bad) > 10 else ""))
