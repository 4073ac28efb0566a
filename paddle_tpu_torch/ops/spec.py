"""The op registry of the port: ``paddle_tpu/ops/spec.py`` with the
port's ops (the api.yaml analog; reference
python/paddle/utils/code_gen/api.yaml).

One source of truth for the public op surface: every entry carries the
public callable (``fn``, the port's op), a numpy reference, a sample input
generator and tolerance / gradient metadata.  The 276 entries have the JAX
registry's names, samples, references, ``grad_wrt``, tolerances and
``bf16`` flags, copied here rather than imported, so the registry needs no
JAX: the CPU tests pair each entry with the JAX one by name, and
``chip_smoke.py`` runs every entry on the card against the CPU.

An entry's ``fn`` takes the sample's arrays as tensors (numpy constants
inside an ``fn`` land on its tensors' device); ``sample`` returns numpy
arrays.  :func:`run` runs an entry on a device and dtype, or takes the
gradient of ``sum(fn)`` by one argument, and gives numpy back.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..framework import dtype as fw_dtype

__all__ = ["OpSpec", "register_op", "registry", "api_table", "run"]


@dataclasses.dataclass
class OpSpec:
    name: str                      # dotted public path under the package
    fn: Callable                   # the framework op
    ref: Callable                  # numpy reference implementation
    sample: Callable               # rng -> tuple of np args
    grad_wrt: Tuple[int, ...] = (0,)   # args to grad-check (() = skip)
    rtol: float = 1e-5
    atol: float = 1e-6
    grad_rtol: float = 5e-3
    grad_atol: float = 5e-4
    bf16: bool = True              # False = dtype-limited (no bf16 kernel)


_REGISTRY: List[OpSpec] = []


def register_op(spec: OpSpec) -> OpSpec:
    _REGISTRY.append(spec)
    return spec


def registry() -> List[OpSpec]:
    if not _REGISTRY:
        _populate()
    return list(_REGISTRY)


def api_table() -> str:
    """Markdown inventory of the registered public op surface."""
    lines = ["| op | grad-checked |", "|---|---|"]
    for s in registry():
        lines.append(f"| `paddle_tpu_torch.{s.name}` | "
                     f"{'yes' if s.grad_wrt else 'n/a'} |")
    return "\n".join(lines)


def run(spec: OpSpec, args, device="cpu", dtype=None, grad_at=None):
    """``spec.fn`` on ``args`` (the sample's arrays) as tensors on
    ``device``, the float ones cast to ``dtype`` (kept as they are for
    None), with ``device`` current for the constants that ``fn`` creates.
    For ``grad_at=i`` the gradient of ``sum(fn(...))`` by argument ``i``
    by autograd instead of the output.  Returns a numpy array."""
    device = torch.device(device)
    with fw_dtype.device_scope("cpu" if device.type == "cpu"
                               else f"gpu:{device.index or 0}"):
        ts = []
        for k, a in enumerate(args):
            t = torch.as_tensor(np.array(a, copy=True))
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            ts.append(t.to(device).requires_grad_(k == grad_at))
        out = spec.fn(*ts)
        if grad_at is not None:
            (out,) = torch.autograd.grad(out.sum(), ts[grad_at])
        return fw_dtype.to_numpy(out)


# ---------------------------------------------------------------------------
# Registration corpus
# ---------------------------------------------------------------------------
def _r(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _pos(rng, *shape):
    return (np.abs(rng.randn(*shape)) + 0.5).astype(np.float32)


def _populate() -> None:
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nn import functional as F

    def unary(name, fn, ref, sample=lambda rng: (_r(rng, 3, 4),), **kw):
        register_op(OpSpec(name=name, fn=fn, ref=ref, sample=sample, **kw))

    def binary(name, fn, ref, sample=None, **kw):
        sample = sample or (lambda rng: (_r(rng, 3, 4), _r(rng, 3, 4)))
        register_op(OpSpec(name=name, fn=fn, ref=ref, sample=sample,
                           grad_wrt=kw.pop("grad_wrt", (0, 1)), **kw))

    # -- math unary (reference tensor/math.py ≙ phi unary kernels) --------
    unary("exp", pt.exp, np.exp)
    unary("log", pt.log, np.log, sample=lambda rng: (_pos(rng, 3, 4),))
    unary("log1p", pt.log1p, np.log1p,
          sample=lambda rng: (_pos(rng, 3, 4),))
    unary("sqrt", pt.sqrt, np.sqrt, sample=lambda rng: (_pos(rng, 3, 4),))
    unary("rsqrt", pt.rsqrt, lambda x: 1.0 / np.sqrt(x),
          sample=lambda rng: (_pos(rng, 3, 4),))
    unary("square", pt.square, np.square)
    unary("abs", pt.abs, np.abs)
    unary("sin", pt.sin, np.sin)
    unary("cos", pt.cos, np.cos)
    unary("tanh", pt.tanh, np.tanh)
    unary("sigmoid", pt.sigmoid, lambda x: 1 / (1 + np.exp(-x)))
    unary("erf", pt.erf,
          lambda x: np.vectorize(_erf_scalar)(x).astype(np.float64))
    unary("floor", pt.floor, np.floor, grad_wrt=())
    unary("ceil", pt.ceil, np.ceil, grad_wrt=())
    unary("round", pt.round, np.round, grad_wrt=())
    unary("sign", pt.sign, np.sign, grad_wrt=())
    unary("reciprocal", pt.reciprocal, lambda x: 1.0 / x,
          sample=lambda rng: (_pos(rng, 3, 4),))

    # -- math binary (broadcasting included) ------------------------------
    binary("add", pt.add, np.add)
    binary("subtract", pt.subtract, np.subtract)
    binary("multiply", pt.multiply, np.multiply)
    binary("divide", pt.divide, np.divide,
           sample=lambda rng: (_r(rng, 3, 4), _pos(rng, 3, 4)))
    binary("maximum", pt.maximum, np.maximum)
    binary("minimum", pt.minimum, np.minimum)
    binary("pow", pt.pow, np.power,
           sample=lambda rng: (_pos(rng, 3, 4), np.float32(2.0)),
           grad_wrt=(0,))
    binary("atan2", pt.atan2, np.arctan2)
    binary("broadcast_add", pt.add, np.add,
           sample=lambda rng: (_r(rng, 3, 4), _r(rng, 1, 4)))

    # -- reductions -------------------------------------------------------
    unary("sum", pt.sum, np.sum, sample=lambda rng: (_r(rng, 3, 4),))
    unary("mean", pt.mean, np.mean)
    unary("max", pt.max, np.max, grad_wrt=())
    unary("min", pt.min, np.min, grad_wrt=())
    unary("prod", pt.prod, np.prod,
          sample=lambda rng: (_pos(rng, 2, 3),))
    register_op(OpSpec(
        name="sum.axis", fn=lambda x: __import__("paddle_tpu_torch").sum(
            x, axis=1, keepdim=True),
        ref=lambda x: np.sum(x, axis=1, keepdims=True),
        sample=lambda rng: (_r(rng, 3, 4),)))

    # -- linalg -----------------------------------------------------------
    register_op(OpSpec(
        name="matmul", fn=pt.matmul, ref=np.matmul,
        sample=lambda rng: (_r(rng, 3, 4), _r(rng, 4, 5)),
        grad_wrt=(0, 1), rtol=2e-5, atol=2e-5))
    register_op(OpSpec(
        name="nn.functional.linear",
        fn=lambda x, w, b: F.linear(x, w, b),
        ref=lambda x, w, b: x @ w + b,
        sample=lambda rng: (_r(rng, 3, 4), _r(rng, 4, 5), _r(rng, 5)),
        grad_wrt=(0, 1, 2), rtol=2e-5, atol=2e-5))

    # -- activations (nn/functional ≙ phi activation kernels) -------------
    unary("nn.functional.relu", F.relu, lambda x: np.maximum(x, 0))
    unary("nn.functional.gelu", F.gelu,
          lambda x: 0.5 * x * (1 + np.vectorize(_erf_scalar)(
              x / np.sqrt(2.0))), rtol=2e-5, atol=2e-5)
    unary("nn.functional.silu", F.silu,
          lambda x: x / (1 + np.exp(-x)))
    unary("nn.functional.softmax",
          lambda x: F.softmax(x, axis=-1), _np_softmax)
    unary("nn.functional.log_softmax",
          lambda x: F.log_softmax(x, axis=-1),
          lambda x: np.log(_np_softmax(x)))
    unary("nn.functional.leaky_relu",
          lambda x: F.leaky_relu(x, negative_slope=0.1),
          lambda x: np.where(x >= 0, x, 0.1 * x))
    unary("nn.functional.hardswish", F.hardswish,
          lambda x: x * np.clip(x + 3, 0, 6) / 6, grad_rtol=2e-2,
          grad_atol=2e-3)

    # -- norm layers (functional form) ------------------------------------
    register_op(OpSpec(
        name="nn.functional.layer_norm",
        fn=lambda x, w, b: F.layer_norm(x, (4,), weight=w, bias=b,
                                        epsilon=1e-5),
        ref=lambda x, w, b: _np_layer_norm(x, w, b, 1e-5),
        sample=lambda rng: (_r(rng, 3, 4), _pos(rng, 4), _r(rng, 4)),
        grad_wrt=(0, 1, 2), rtol=2e-5, atol=2e-5))

    # -- losses -----------------------------------------------------------
    register_op(OpSpec(
        name="nn.functional.cross_entropy",
        fn=lambda lg, lb: F.cross_entropy(lg, lb, reduction="mean"),
        ref=lambda lg, lb: -np.mean(
            np.log(_np_softmax(lg))[np.arange(lg.shape[0]), lb]),
        sample=lambda rng: (_r(rng, 6, 10),
                            rng.randint(0, 10, (6,)).astype(np.int32)),
        grad_wrt=(0,), rtol=2e-5, atol=2e-5))
    register_op(OpSpec(
        name="nn.functional.mse_loss",
        fn=lambda a, b: F.mse_loss(a, b),
        ref=lambda a, b: np.mean((a - b) ** 2),
        sample=lambda rng: (_r(rng, 3, 4), _r(rng, 3, 4)),
        grad_wrt=(0, 1)))

    # -- shape ops --------------------------------------------------------
    register_op(OpSpec(
        name="concat", fn=lambda a, b: pt.concat([a, b], axis=1),
        ref=lambda a, b: np.concatenate([a, b], axis=1),
        sample=lambda rng: (_r(rng, 3, 4), _r(rng, 3, 2)),
        grad_wrt=(0, 1)))
    register_op(OpSpec(
        name="transpose", fn=lambda x: pt.transpose(x, (1, 0)),
        ref=lambda x: x.T, sample=lambda rng: (_r(rng, 3, 4),)))
    register_op(OpSpec(
        name="reshape", fn=lambda x: pt.reshape(x, (4, 3)),
        ref=lambda x: x.reshape(4, 3),
        sample=lambda rng: (_r(rng, 3, 4),)))
    register_op(OpSpec(
        name="clip", fn=lambda x: pt.clip(x, -0.5, 0.5),
        ref=lambda x: np.clip(x, -0.5, 0.5),
        sample=lambda rng: (_r(rng, 3, 4),)))
    register_op(OpSpec(
        name="where", fn=lambda c, a, b: pt.where(c, a, b),
        ref=np.where,
        sample=lambda rng: (rng.rand(3, 4) > 0.5, _r(rng, 3, 4),
                            _r(rng, 3, 4)),
        grad_wrt=(1, 2)))
    register_op(OpSpec(
        name="gather",
        fn=lambda x, i: pt.gather(x, i, axis=0),
        ref=lambda x, i: np.take(x, i, axis=0),
        sample=lambda rng: (_r(rng, 5, 4),
                            rng.randint(0, 5, (3,)).astype(np.int32)),
        grad_wrt=(0,)))
    register_op(OpSpec(
        name="cumsum", fn=lambda x: pt.cumsum(x, axis=1),
        ref=lambda x: np.cumsum(x, axis=1),
        sample=lambda rng: (_r(rng, 3, 4),)))

    # -- extended corpus (tensor_ops.py / linalg.py) -----------------------
    unary("logsumexp", lambda x: pt.logsumexp(x, axis=1),
          lambda x: np.log(np.sum(np.exp(x), axis=1)))
    unary("expm1", pt.expm1, np.expm1)
    unary("log2", pt.log2, np.log2, sample=lambda rng: (_pos(rng, 3, 4),))
    unary("log10", pt.log10, np.log10,
          sample=lambda rng: (_pos(rng, 3, 4),))
    unary("asin", pt.asin, np.arcsin,
          sample=lambda rng: (rng.uniform(-0.9, 0.9, (3, 4)).astype(
              np.float32),))
    unary("acos", pt.acos, np.arccos,
          sample=lambda rng: (rng.uniform(-0.9, 0.9, (3, 4)).astype(
              np.float32),))
    unary("atan", pt.atan, np.arctan)
    unary("sinh", pt.sinh, np.sinh)
    unary("cosh", pt.cosh, np.cosh)
    unary("tan", pt.tan, np.tan,
          sample=lambda rng: (rng.uniform(-1.0, 1.0, (3, 4)).astype(
              np.float32),))
    unary("deg2rad", pt.deg2rad, np.deg2rad)
    unary("rad2deg", pt.rad2deg, np.rad2deg)
    unary("frac", pt.frac, lambda x: x - np.trunc(x), grad_wrt=())
    unary("erfinv", pt.erfinv,
          sample=lambda rng: (rng.uniform(-0.8, 0.8, (3, 4)).astype(
              np.float32),),
          ref=lambda x: np.vectorize(_erfinv_scalar)(x).astype(np.float64),
          rtol=1e-4, atol=1e-5, grad_rtol=2e-2, grad_atol=2e-3)
    unary("logit", lambda x: pt.logit(x),
          lambda x: np.log(x) - np.log1p(-x),
          sample=lambda rng: (rng.uniform(0.1, 0.9, (3, 4)).astype(
              np.float32),))
    unary("stanh", pt.stanh,
          lambda x: 1.7159 * np.tanh(0.67 * x))
    unary("trace", pt.trace, np.trace,
          sample=lambda rng: (_r(rng, 4, 4),))
    unary("diagonal", lambda x: pt.diagonal(x, offset=1),
          lambda x: np.diagonal(x, offset=1),
          sample=lambda rng: (_r(rng, 4, 4),))
    unary("median", lambda x: pt.median(x, axis=1),
          lambda x: np.median(x, axis=1),
          sample=lambda rng: (_r(rng, 3, 5),), grad_wrt=())
    unary("quantile", lambda x: pt.quantile(x, 0.25, axis=1),
          lambda x: np.quantile(x, 0.25, axis=1),
          sample=lambda rng: (_r(rng, 3, 5),), grad_wrt=())
    unary("amax", lambda x: pt.amax(x, axis=1),
          lambda x: np.max(x, axis=1), grad_wrt=())
    unary("amin", lambda x: pt.amin(x, axis=1),
          lambda x: np.min(x, axis=1), grad_wrt=())
    unary("moveaxis", lambda x: pt.moveaxis(x, 0, 1),
          lambda x: np.moveaxis(x, 0, 1))
    unary("rot90", lambda x: pt.rot90(x),
          lambda x: np.rot90(x), sample=lambda rng: (_r(rng, 3, 4),))
    unary("repeat_interleave",
          lambda x: pt.repeat_interleave(x, 2, axis=1),
          lambda x: np.repeat(x, 2, axis=1))
    def _with_nans(rng):
        x = _r(rng, 3, 5)
        x[0, 1] = np.nan
        x[2, 3] = np.nan
        return (x,)

    unary("nanmean", lambda x: pt.nanmean(x, axis=1),
          lambda x: np.nanmean(x, axis=1), sample=_with_nans, grad_wrt=())
    binary("hypot", pt.hypot, np.hypot)
    binary("copysign", pt.copysign, np.copysign, grad_wrt=(0,))
    binary("lerp", lambda x, y: pt.lerp(x, y, 0.3),
           lambda x, y: x + 0.3 * (y - x))
    binary("kron", pt.kron, np.kron,
           sample=lambda rng: (_r(rng, 2, 3), _r(rng, 3, 2)))
    binary("inner", pt.inner, np.inner,
           sample=lambda rng: (_r(rng, 4), _r(rng, 4)))
    binary("mv", pt.mv, lambda m, v: m @ v,
           sample=lambda rng: (_r(rng, 3, 4), _r(rng, 4)))
    binary("tensordot", lambda a, b: pt.tensordot(a, b, axes=1),
           lambda a, b: np.tensordot(a, b, axes=1),
           sample=lambda rng: (_r(rng, 3, 4), _r(rng, 4, 5)))
    binary("addmm_default",
           lambda i, a: pt.addmm(i, a, np.eye(4, dtype=np.float32)),
           lambda i, a: i + a,
           sample=lambda rng: (_r(rng, 3, 4), _r(rng, 3, 4)))
    register_op(OpSpec(
        name="gcd", fn=pt.gcd, ref=np.gcd,
        sample=lambda rng: (rng.randint(1, 40, (6,)).astype(np.int32),
                            rng.randint(1, 40, (6,)).astype(np.int32)),
        grad_wrt=()))
    register_op(OpSpec(
        name="searchsorted",
        fn=lambda e, v: pt.searchsorted(e, v),
        ref=lambda e, v: np.searchsorted(e, v),
        sample=lambda rng: (np.sort(_r(rng, 6)), _r(rng, 4)),
        grad_wrt=()))
    register_op(OpSpec(
        name="linalg.det", fn=pt.linalg.det, ref=np.linalg.det,
        sample=lambda rng: (_r(rng, 3, 3) + 3 * np.eye(3, dtype=np.float32),),
        grad_wrt=(0,), rtol=1e-4, atol=1e-4,
        grad_rtol=2e-2, grad_atol=2e-3))
    register_op(OpSpec(
        name="linalg.inv", fn=pt.linalg.inv, ref=np.linalg.inv,
        sample=lambda rng: (_r(rng, 3, 3) + 3 * np.eye(3, dtype=np.float32),),
        grad_wrt=(0,), rtol=1e-4, atol=1e-4,
        grad_rtol=2e-2, grad_atol=2e-3))
    register_op(OpSpec(
        name="linalg.solve",
        fn=pt.linalg.solve, ref=np.linalg.solve,
        sample=lambda rng: (_r(rng, 3, 3) + 3 * np.eye(3, dtype=np.float32),
                            _r(rng, 3, 2)),
        grad_wrt=(0, 1), rtol=1e-4, atol=1e-4,
        grad_rtol=2e-2, grad_atol=2e-3))
    register_op(OpSpec(
        name="linalg.multi_dot",
        fn=lambda a, b, c: pt.linalg.multi_dot([a, b, c]),
        ref=lambda a, b, c: a @ b @ c,
        sample=lambda rng: (_r(rng, 2, 3), _r(rng, 3, 4), _r(rng, 4, 2)),
        grad_wrt=(0, 1, 2), rtol=1e-4, atol=1e-5))
    unary("nn.functional.relu6", F.relu6, lambda x: np.clip(x, 0, 6),
          grad_rtol=2e-2, grad_atol=2e-3)
    unary("nn.functional.elu", F.elu,
          lambda x: np.where(x > 0, x, np.exp(x) - 1))
    unary("nn.functional.mish", F.mish,
          lambda x: x * np.tanh(np.log1p(np.exp(x))))
    unary("nn.functional.softplus", F.softplus,
          lambda x: np.log1p(np.exp(x)))
    unary("nn.functional.hardsigmoid", F.hardsigmoid,
          lambda x: np.clip(x / 6 + 0.5, 0, 1), grad_rtol=2e-2,
          grad_atol=2e-3)
    unary("nn.functional.glu", lambda x: F.glu(x, axis=-1),
          lambda x: x[..., :x.shape[-1] // 2]
          / (1 + np.exp(-x[..., x.shape[-1] // 2:])),
          sample=lambda rng: (_r(rng, 3, 8),))
    register_op(OpSpec(
        name="nn.functional.cosine_similarity",
        fn=lambda a, b: F.cosine_similarity(a, b, axis=1),
        ref=lambda a, b: np.sum(a * b, 1)
        / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)),
        sample=lambda rng: (_r(rng, 3, 8), _r(rng, 3, 8)),
        grad_wrt=(0, 1)))
    register_op(OpSpec(
        name="nn.functional.kl_div",
        fn=lambda i, t: F.kl_div(i, t, reduction="mean"),
        ref=lambda i, t: np.mean(np.where(
            t > 0, t * (np.log(np.maximum(t, 1e-30)) - i), 0.0)),
        sample=lambda rng: (np.log(_np_softmax(_r(rng, 4, 5))),
                            _np_softmax(_r(rng, 4, 5))),
        grad_wrt=(0,)))

    _populate_round5(unary, binary)


def _populate_round5(unary, binary) -> None:
    """The tensor / linalg / fft / signal / functional corpus, registered
    so the numpy-parity, gradient and bf16 sweeps cover it."""

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nn import functional as F

    def _ints(rng, lo, hi, *shape):
        return rng.randint(lo, hi, shape).astype(np.int32)

    def _bools(rng, *shape):
        return rng.rand(*shape) > 0.5

    # -- comparisons / logicals (grad-free) -------------------------------
    for name, npf in [("equal", np.equal), ("not_equal", np.not_equal),
                      ("greater_than", np.greater),
                      ("greater_equal", np.greater_equal),
                      ("less_than", np.less), ("less_equal", np.less_equal)]:
        binary(name, getattr(pt, name), npf, grad_wrt=())
    for name, npf in [("logical_and", np.logical_and),
                      ("logical_or", np.logical_or),
                      ("logical_xor", np.logical_xor)]:
        register_op(OpSpec(
            name=name, fn=getattr(pt, name), ref=npf,
            sample=lambda rng: (_bools(rng, 3, 4), _bools(rng, 3, 4)),
            grad_wrt=()))
    register_op(OpSpec(
        name="logical_not", fn=pt.logical_not, ref=np.logical_not,
        sample=lambda rng: (_bools(rng, 3, 4),), grad_wrt=()))
    for name, npf in [("bitwise_and", np.bitwise_and),
                      ("bitwise_or", np.bitwise_or),
                      ("bitwise_xor", np.bitwise_xor)]:
        register_op(OpSpec(
            name=name, fn=getattr(pt, name), ref=npf,
            sample=lambda rng: (_ints(rng, 0, 16, 3, 4),
                                _ints(rng, 0, 16, 3, 4)),
            grad_wrt=()))
    register_op(OpSpec(
        name="isclose", fn=pt.isclose, ref=np.isclose,
        sample=lambda rng: (_r(rng, 3, 4), _r(rng, 3, 4)), grad_wrt=()))

    # -- predicates / reductions over bool --------------------------------
    def _specials(rng):
        x = _r(rng, 3, 4)
        x[0, 0], x[1, 1], x[2, 2] = np.nan, np.inf, -np.inf
        return (x,)

    unary("isnan", pt.isnan, np.isnan, sample=_specials, grad_wrt=())
    unary("isinf", pt.isinf, np.isinf, sample=_specials, grad_wrt=())
    unary("isfinite", pt.isfinite, np.isfinite, sample=_specials,
          grad_wrt=())
    register_op(OpSpec(
        name="all", fn=lambda x: pt.all(x, axis=1),
        ref=lambda x: np.all(x, axis=1),
        sample=lambda rng: (_bools(rng, 3, 4),), grad_wrt=()))
    register_op(OpSpec(
        name="any", fn=lambda x: pt.any(x, axis=1),
        ref=lambda x: np.any(x, axis=1),
        sample=lambda rng: (_bools(rng, 3, 4),), grad_wrt=()))

    # -- index / argsort family (grad-free) -------------------------------
    unary("argmax", lambda x: pt.argmax(x, axis=1),
          lambda x: np.argmax(x, axis=1), grad_wrt=())
    unary("argmin", lambda x: pt.argmin(x, axis=1),
          lambda x: np.argmin(x, axis=1), grad_wrt=())
    unary("argsort", lambda x: pt.argsort(x, axis=1),
          lambda x: np.argsort(x, axis=1, kind="stable"), grad_wrt=())
    unary("sort", lambda x: pt.sort(x, axis=1),
          lambda x: np.sort(x, axis=1))
    unary("topk", lambda x: pt.topk(x, 3, axis=1)[0],
          lambda x: -np.sort(-x, axis=1)[:, :3],
          sample=lambda rng: (_r(rng, 3, 6),), grad_wrt=())
    unary("kthvalue", lambda x: pt.kthvalue(x, 2, axis=1)[0],
          lambda x: np.sort(x, axis=1)[:, 1],
          sample=lambda rng: (_r(rng, 3, 6),), grad_wrt=())
    register_op(OpSpec(
        name="mode", fn=lambda x: pt.mode(x, axis=1)[0],
        ref=_np_mode_rows,
        sample=lambda rng: (_ints(rng, 0, 3, 4, 7).astype(np.float32),),
        grad_wrt=()))
    register_op(OpSpec(
        name="bincount", fn=pt.bincount, ref=np.bincount,
        sample=lambda rng: (_ints(rng, 0, 8, 20),), grad_wrt=()))
    register_op(OpSpec(
        name="histogram",
        fn=lambda x: pt.histogram(x, bins=5, min=-2.0, max=2.0),
        ref=lambda x: np.histogram(x, bins=5, range=(-2.0, 2.0))[0],
        sample=lambda rng: (_r(rng, 20),), grad_wrt=()))
    register_op(OpSpec(
        name="bucketize",
        fn=lambda x, e: pt.bucketize(x, e),
        ref=lambda x, e: np.searchsorted(e, x),
        sample=lambda rng: (_r(rng, 8), np.sort(_r(rng, 5))),
        grad_wrt=()))
    register_op(OpSpec(
        name="index_select",
        fn=lambda x, i: pt.index_select(x, i, axis=1),
        ref=lambda x, i: np.take(x, i, axis=1),
        sample=lambda rng: (_r(rng, 3, 6), _ints(rng, 0, 6, 4)),
        grad_wrt=(0,)))
    register_op(OpSpec(
        name="index_sample",
        fn=pt.index_sample,
        ref=lambda x, i: np.take_along_axis(x, i, axis=1),
        sample=lambda rng: (_r(rng, 3, 6), _ints(rng, 0, 6, 3, 2)),
        grad_wrt=(0,)))
    register_op(OpSpec(
        name="take_along_axis",
        fn=lambda x, i: pt.take_along_axis(x, i, axis=1),
        ref=lambda x, i: np.take_along_axis(x, i, axis=1),
        sample=lambda rng: (_r(rng, 3, 6), _ints(rng, 0, 6, 3, 2)),
        grad_wrt=(0,)))
    register_op(OpSpec(
        name="put_along_axis",
        fn=lambda x, i, v: pt.put_along_axis(x, i, v, axis=1),
        ref=_np_put_along_axis,
        sample=lambda rng: (_r(rng, 3, 6), _ints(rng, 0, 6, 3, 2),
                            _r(rng, 3, 2)),
        grad_wrt=(0, 2)))
    register_op(OpSpec(
        name="gather_nd", fn=pt.gather_nd,
        ref=lambda x, i: x[tuple(np.moveaxis(i, -1, 0))],
        sample=lambda rng: (_r(rng, 4, 5),
                            np.stack([_ints(rng, 0, 4, 3),
                                      _ints(rng, 0, 5, 3)], -1)),
        grad_wrt=(0,)))
    register_op(OpSpec(
        name="scatter",
        fn=lambda x, i, u: pt.scatter(x, i, u),
        ref=_np_scatter_overwrite,
        sample=lambda rng: (_r(rng, 5, 3), np.asarray([0, 2], np.int32),
                            _r(rng, 2, 3)),
        grad_wrt=(0, 2)))
    register_op(OpSpec(
        name="multiplex",
        fn=lambda a, b, i: pt.multiplex([a, b], i),
        ref=lambda a, b, i: np.where((i == 0)[:, None] if i.ndim == 1
                                     else (i == 0), a, b),
        sample=lambda rng: (_r(rng, 4, 3), _r(rng, 4, 3),
                            _ints(rng, 0, 2, 4)),
        grad_wrt=()))

    # -- shape manipulation ------------------------------------------------
    unary("flip", lambda x: pt.flip(x, axis=0), lambda x: np.flip(x, 0))
    unary("roll", lambda x: pt.roll(x, 2, axis=1),
          lambda x: np.roll(x, 2, axis=1))
    unary("tile", lambda x: pt.tile(x, (2, 3)),
          lambda x: np.tile(x, (2, 3)))
    unary("broadcast_to", lambda x: pt.broadcast_to(x, (3, 4)),
          lambda x: np.broadcast_to(x, (3, 4)),
          sample=lambda rng: (_r(rng, 1, 4),))
    unary("expand", lambda x: pt.expand(x, (3, 4)),
          lambda x: np.broadcast_to(x, (3, 4)),
          sample=lambda rng: (_r(rng, 1, 4),))
    unary("squeeze", lambda x: pt.squeeze(x, axis=1),
          lambda x: np.squeeze(x, 1),
          sample=lambda rng: (_r(rng, 3, 1, 4),))
    unary("unsqueeze", lambda x: pt.unsqueeze(x, axis=1),
          lambda x: np.expand_dims(x, 1))
    unary("stack_pair", lambda x: pt.stack([x, x], axis=0),
          lambda x: np.stack([x, x], 0))
    unary("split", lambda x: pt.split(x, 2, axis=1)[0],
          lambda x: np.split(x, 2, axis=1)[0])
    unary("chunk", lambda x: pt.chunk(x, 2, axis=1)[1],
          lambda x: np.array_split(x, 2, axis=1)[1])
    unary("unbind", lambda x: pt.unbind(x, axis=0)[1],
          lambda x: x[1])
    unary("t", pt.t, lambda x: x.T)
    unary("tril", pt.tril, np.tril, sample=lambda rng: (_r(rng, 4, 4),))
    unary("triu", pt.triu, np.triu, sample=lambda rng: (_r(rng, 4, 4),))
    unary("diag", pt.diag, np.diag, sample=lambda rng: (_r(rng, 4),))
    unary("diagflat", pt.diagflat, np.diagflat,
          sample=lambda rng: (_r(rng, 2, 3),))

    # -- more math ---------------------------------------------------------
    unary("neg", pt.neg, np.negative)
    unary("trunc", pt.trunc, np.trunc, grad_wrt=())
    unary("digamma", pt.digamma, np.vectorize(_digamma_scalar),
          sample=lambda rng: (_pos(rng, 3, 4),), rtol=1e-4, atol=1e-5,
          grad_rtol=2e-2, grad_atol=2e-3)
    unary("cumprod", lambda x: pt.cumprod(x, 1),
          lambda x: np.cumprod(x, axis=1),
          sample=lambda rng: (_pos(rng, 2, 4),))
    unary("logcumsumexp", lambda x: pt.logcumsumexp(x, axis=1),
          lambda x: np.log(np.cumsum(np.exp(x), axis=1)),
          rtol=2e-5, atol=2e-5, grad_rtol=2e-2, grad_atol=2e-3)
    unary("diff", lambda x: pt.diff(x, axis=1),
          lambda x: np.diff(x, axis=1))
    unary("nansum", lambda x: pt.nansum(x, axis=1),
          lambda x: np.nansum(x, axis=1), sample=_nan_sample, grad_wrt=())
    unary("nanmedian", lambda x: pt.nanmedian(x, axis=1),
          lambda x: np.nanmedian(x, axis=1), sample=_nan_sample,
          grad_wrt=())
    unary("std", lambda x: pt.std(x, axis=1),
          lambda x: np.std(x, axis=1, ddof=1))
    unary("var", lambda x: pt.var(x, axis=1),
          lambda x: np.var(x, axis=1, ddof=1))
    unary("norm_fro", pt.norm,
          lambda x: np.linalg.norm(x.reshape(-1)))
    unary("scale", lambda x: pt.scale(x, scale=2.0, bias=1.0),
          lambda x: 2.0 * x + 1.0)
    unary("renorm", lambda x: pt.renorm(x, p=2.0, axis=0, max_norm=1.0),
          _np_renorm, sample=lambda rng: (_r(rng, 3, 4) * 2,))
    binary("mod", pt.mod, np.mod,
           sample=lambda rng: (_r(rng, 3, 4), _pos(rng, 3, 4)),
           grad_wrt=(0,))
    binary("floor_divide", pt.floor_divide, np.floor_divide,
           sample=lambda rng: (_r(rng, 3, 4), _pos(rng, 3, 4)),
           grad_wrt=())
    binary("fmax", pt.fmax, np.fmax)
    binary("fmin", pt.fmin, np.fmin)
    binary("ldexp", pt.ldexp, np.ldexp,
           sample=lambda rng: (_r(rng, 3, 4), _ints(rng, -3, 4, 3, 4)),
           grad_wrt=(0,))
    register_op(OpSpec(
        name="lcm", fn=pt.lcm, ref=np.lcm,
        sample=lambda rng: (_ints(rng, 1, 20, 6), _ints(rng, 1, 20, 6)),
        grad_wrt=()))
    binary("dot", pt.dot, np.dot,
           sample=lambda rng: (_r(rng, 5), _r(rng, 5)))
    binary("outer", pt.outer, np.outer,
           sample=lambda rng: (_r(rng, 3), _r(rng, 4)))
    binary("cross", pt.cross, np.cross,
           sample=lambda rng: (_r(rng, 4, 3), _r(rng, 4, 3)))
    binary("mm", pt.mm, np.matmul,
           sample=lambda rng: (_r(rng, 3, 4), _r(rng, 4, 5)),
           rtol=2e-5, atol=2e-5)
    binary("bmm", pt.bmm, np.matmul,
           sample=lambda rng: (_r(rng, 2, 3, 4), _r(rng, 2, 4, 5)),
           rtol=2e-5, atol=2e-5, grad_rtol=2e-2, grad_atol=2e-3)
    binary("dist", pt.dist,
           lambda a, b: np.linalg.norm((a - b).reshape(-1)))
    register_op(OpSpec(
        name="einsum_ij_jk",
        fn=lambda a, b: pt.einsum("ij,jk->ik", a, b),
        ref=lambda a, b: np.einsum("ij,jk->ik", a, b),
        sample=lambda rng: (_r(rng, 3, 4), _r(rng, 4, 5)),
        grad_wrt=(0, 1), rtol=2e-5, atol=2e-5))

    # -- linalg (decompositions compared invariantly) ----------------------
    def _spd(rng, n=3):
        a = _r(rng, n, n)
        return (a @ a.T + n * np.eye(n, dtype=np.float32),)

    register_op(OpSpec(
        name="linalg.cholesky", fn=pt.linalg.cholesky,
        ref=np.linalg.cholesky, sample=_spd, grad_wrt=(0,),
        rtol=1e-4, atol=1e-4, grad_rtol=2e-2, grad_atol=2e-3))
    register_op(OpSpec(
        name="linalg.qr_reconstruct",
        fn=lambda x: (lambda qr: qr[0] @ qr[1])(pt.linalg.qr(x)),
        ref=lambda x: x, sample=lambda rng: (_r(rng, 4, 3),),
        grad_wrt=(), rtol=1e-4, atol=1e-4))
    register_op(OpSpec(
        name="linalg.svdvals",
        fn=lambda x: pt.linalg.svd(x)[1],
        ref=lambda x: np.linalg.svd(x, compute_uv=False),
        sample=lambda rng: (_r(rng, 4, 3),), grad_wrt=(),
        rtol=1e-4, atol=1e-4))
    register_op(OpSpec(
        name="linalg.eigvalsh",
        fn=lambda x: pt.linalg.eigvalsh((x + x.T) / 2),
        ref=lambda x: np.linalg.eigvalsh((x + x.T) / 2),
        sample=lambda rng: (_r(rng, 4, 4),), grad_wrt=(),
        rtol=1e-4, atol=1e-4))
    register_op(OpSpec(
        name="linalg.matrix_power",
        fn=lambda x: pt.linalg.matrix_power(x, 3),
        ref=lambda x: np.linalg.matrix_power(x, 3),
        sample=_spd, grad_wrt=(0,), rtol=1e-3, atol=1e-3,
        grad_rtol=5e-2, grad_atol=5e-2))
    register_op(OpSpec(
        name="linalg.matrix_rank",
        fn=lambda x: pt.linalg.matrix_rank(x, tol=1e-4),
        ref=lambda x: np.linalg.matrix_rank(x, tol=1e-4),
        sample=lambda rng: (np.outer(_r(rng, 4), _r(rng, 4)),),
        grad_wrt=()))
    register_op(OpSpec(
        name="linalg.pinv", fn=pt.linalg.pinv, ref=np.linalg.pinv,
        sample=_spd, grad_wrt=(), rtol=1e-3, atol=1e-3))
    register_op(OpSpec(
        name="linalg.slogdet_logabs",
        fn=lambda x: pt.linalg.slogdet(x)[1],
        ref=lambda x: np.linalg.slogdet(x)[1],
        sample=_spd, grad_wrt=(0,), rtol=1e-4, atol=1e-4,
        grad_rtol=2e-2, grad_atol=2e-3))
    register_op(OpSpec(
        name="linalg.cond", fn=pt.linalg.cond, ref=np.linalg.cond,
        sample=_spd, grad_wrt=(), rtol=1e-3, atol=1e-3))
    register_op(OpSpec(
        name="linalg.lstsq_solution",
        fn=lambda a, b: pt.linalg.lstsq(a, b)[0],
        ref=lambda a, b: np.linalg.lstsq(a, b, rcond=None)[0],
        sample=lambda rng: (_r(rng, 6, 3), _r(rng, 6, 2)),
        grad_wrt=(), rtol=1e-3, atol=1e-3))
    register_op(OpSpec(
        name="linalg.triangular_solve",
        fn=lambda a, b: pt.linalg.triangular_solve(a, b, upper=False),
        ref=lambda a, b: np.linalg.solve(np.tril(a), b),
        sample=lambda rng: (np.tril(_r(rng, 3, 3))
                            + 3 * np.eye(3, dtype=np.float32),
                            _r(rng, 3, 2)),
        grad_wrt=(0, 1), rtol=1e-4, atol=1e-4,
        grad_rtol=2e-2, grad_atol=2e-3))
    register_op(OpSpec(
        name="linalg.norm_axis",
        fn=lambda x: pt.linalg.norm(x, p=2, axis=1),
        ref=lambda x: np.linalg.norm(x, ord=2, axis=1),
        sample=lambda rng: (_r(rng, 3, 5),), grad_wrt=(0,)))
    register_op(OpSpec(
        name="linalg.cov", fn=pt.linalg.cov, ref=np.cov,
        sample=lambda rng: (_r(rng, 3, 8),), grad_wrt=(0,),
        rtol=1e-4, atol=1e-5))

    # -- fft (complex outputs compared directly; grads n/a) ----------------
    for name in ["fft", "ifft", "fft2", "fftshift", "ifftshift"]:
        register_op(OpSpec(
            name=f"fft.{name}", fn=getattr(pt.fft, name),
            ref=getattr(np.fft, name),
            sample=lambda rng: (_r(rng, 4, 8),),
            grad_wrt=(), rtol=1e-4, atol=1e-4, bf16=False))
    register_op(OpSpec(
        name="fft.rfft", fn=pt.fft.rfft, ref=np.fft.rfft,
        sample=lambda rng: (_r(rng, 8),), grad_wrt=(),
        rtol=1e-4, atol=1e-4, bf16=False))
    register_op(OpSpec(
        name="fft.irfft", fn=pt.fft.irfft,
        ref=lambda x: np.fft.irfft(x),
        sample=lambda rng: (np.fft.rfft(_r(rng, 8)),), grad_wrt=(),
        rtol=1e-4, atol=1e-4))

    # -- nn.functional: pooling / conv / resampling ------------------------
    register_op(OpSpec(
        name="nn.functional.avg_pool2d",
        fn=lambda x: F.avg_pool2d(x, 2),
        ref=lambda x: x.reshape(2, 3, 2, 2, 2, 2).mean((3, 5)),
        sample=lambda rng: (_r(rng, 2, 3, 4, 4),), grad_wrt=(0,)))
    register_op(OpSpec(
        name="nn.functional.max_pool2d",
        fn=lambda x: F.max_pool2d(x, 2),
        ref=lambda x: x.reshape(2, 3, 2, 2, 2, 2).max((3, 5)),
        sample=lambda rng: (_r(rng, 2, 3, 4, 4),), grad_wrt=(0,)))
    register_op(OpSpec(
        name="nn.functional.adaptive_avg_pool2d",
        fn=lambda x: F.adaptive_avg_pool2d(x, (3, 3)),
        ref=lambda x: _np_adaptive_pool(x, 3, np.mean),
        sample=lambda rng: (_r(rng, 2, 2, 5, 5),), grad_wrt=(0,)))
    register_op(OpSpec(
        name="nn.functional.adaptive_max_pool2d",
        fn=lambda x: F.adaptive_max_pool2d(x, (3, 3)),
        ref=lambda x: _np_adaptive_pool(x, 3, np.max),
        sample=lambda rng: (_r(rng, 2, 2, 5, 5),), grad_wrt=(0,)))
    register_op(OpSpec(
        name="nn.functional.conv2d",
        fn=lambda x, w: F.conv2d(x, w, padding=1),
        ref=lambda x, w: _np_conv2d(x, w, pad=1),
        sample=lambda rng: (_r(rng, 1, 2, 4, 4), _r(rng, 3, 2, 3, 3)),
        grad_wrt=(0, 1), rtol=2e-5, atol=2e-5, grad_rtol=2e-2,
        grad_atol=2e-3))
    register_op(OpSpec(
        name="nn.functional.interpolate_nearest",
        fn=lambda x: F.interpolate(x, scale_factor=2, mode="nearest"),
        ref=lambda x: x.repeat(2, axis=2).repeat(2, axis=3),
        sample=lambda rng: (_r(rng, 1, 2, 3, 3),), grad_wrt=(0,)))
    register_op(OpSpec(
        name="nn.functional.pad",
        fn=lambda x: F.pad(x, [1, 2], value=0.5),
        ref=lambda x: np.pad(x, ((0, 0), (0, 0), (0, 0), (1, 2)),
                             constant_values=0.5),
        sample=lambda rng: (_r(rng, 1, 2, 3, 3),), grad_wrt=(0,)))
    register_op(OpSpec(
        name="nn.functional.pixel_shuffle",
        fn=lambda x: F.pixel_shuffle(x, 2),
        ref=_np_pixel_shuffle,
        sample=lambda rng: (_r(rng, 1, 8, 3, 3),), grad_wrt=(0,)))
    register_op(OpSpec(
        name="nn.functional.pixel_unshuffle",
        fn=lambda x: F.pixel_unshuffle(x, 2),
        ref=lambda x: _np_pixel_unshuffle(x, 2),
        sample=lambda rng: (_r(rng, 1, 2, 4, 4),), grad_wrt=(0,)))

    # -- nn.functional: embeddings / norms / misc --------------------------
    register_op(OpSpec(
        name="nn.functional.embedding",
        fn=lambda i, w: F.embedding(i, w),
        ref=lambda i, w: w[i],
        sample=lambda rng: (_ints(rng, 0, 6, 3, 4), _r(rng, 6, 5)),
        grad_wrt=(1,)))
    register_op(OpSpec(
        name="nn.functional.one_hot",
        fn=lambda i: F.one_hot(i, 6),
        ref=lambda i: np.eye(6, dtype=np.float32)[i],
        sample=lambda rng: (_ints(rng, 0, 6, 7),), grad_wrt=()))
    unary("nn.functional.normalize",
          lambda x: F.normalize(x, axis=1),
          lambda x: x / np.maximum(
              np.linalg.norm(x, axis=1, keepdims=True), 1e-12))
    # cubed so sum-reduction grads are nonzero: both sum(y) and sum(y^2)
    # of a normalized group are constants, leaving only fd noise
    register_op(OpSpec(
        name="nn.functional.group_norm",
        fn=lambda x: F.group_norm(x, 2) ** 3,
        ref=lambda x: _np_group_norm(x, 2, 1e-5) ** 3,
        sample=lambda rng: (_r(rng, 2, 4, 3, 3),), grad_wrt=(0,),
        rtol=2e-5, atol=2e-5, grad_rtol=2e-2, grad_atol=2e-3))
    unary("nn.functional.rms_norm", F.rms_norm,
          lambda x: x / np.sqrt(np.mean(x * x, -1, keepdims=True) + 1e-6),
          rtol=2e-5, atol=2e-5)
    register_op(OpSpec(
        name="nn.functional.batch_norm_eval",
        fn=lambda x, m, v: F.batch_norm(x, m, v, training=False)[0],
        ref=lambda x, m, v: (x - m[None, :, None, None])
        / np.sqrt(v[None, :, None, None] + 1e-5),
        sample=lambda rng: (_r(rng, 2, 3, 4, 4), _r(rng, 3),
                            _pos(rng, 3)),
        grad_wrt=(0,), rtol=2e-5, atol=2e-5, grad_rtol=2e-2,
        grad_atol=2e-3))
    register_op(OpSpec(
        name="nn.functional.dropout_eval",
        fn=lambda x: F.dropout(x, 0.5, training=False),
        ref=lambda x: x, sample=lambda rng: (_r(rng, 3, 4),)))
    unary("nn.functional.swish", F.swish,
          lambda x: x / (1 + np.exp(-x)))
    register_op(OpSpec(
        name="nn.functional.prelu",
        fn=F.prelu,
        ref=lambda x, w: np.where(x >= 0, x, x * w[None, :, None, None]),
        # keep |x| away from the kink so finite differences are valid
        sample=lambda rng: (np.sign(_r(rng, 2, 3, 4, 4))
                            * (np.abs(_r(rng, 2, 3, 4, 4)) * 0.5 + 0.3),
                            _pos(rng, 3) * 0.1),
        grad_wrt=(0, 1)))
    register_op(OpSpec(
        name="nn.functional.softmax_mask_fuse_upper_triangle",
        fn=F.softmax_mask_fuse_upper_triangle,
        ref=_np_causal_softmax,
        sample=lambda rng: (_r(rng, 2, 2, 4, 4),),
        grad_wrt=(0,), rtol=2e-5, atol=2e-5))
    register_op(OpSpec(
        name="nn.functional.label_smooth",
        fn=lambda x: F.label_smooth(x, epsilon=0.1),
        ref=lambda x: x * 0.9 + 0.1 / x.shape[-1],
        sample=lambda rng: (np.eye(4, dtype=np.float32)[
            np.random.RandomState(0).randint(0, 4, 5)],)))

    # -- nn.functional: losses ---------------------------------------------
    register_op(OpSpec(
        name="nn.functional.l1_loss",
        fn=lambda a, b: F.l1_loss(a, b),
        ref=lambda a, b: np.mean(np.abs(a - b)),
        sample=lambda rng: (_r(rng, 3, 4), _r(rng, 3, 4)),
        grad_wrt=(0,)))
    register_op(OpSpec(
        name="nn.functional.smooth_l1_loss",
        fn=lambda a, b: F.smooth_l1_loss(a, b),
        ref=lambda a, b: np.mean(np.where(
            np.abs(a - b) < 1.0, 0.5 * (a - b) ** 2,
            np.abs(a - b) - 0.5)),
        sample=lambda rng: (_r(rng, 3, 4) * 2, _r(rng, 3, 4)),
        grad_wrt=(0,)))
    register_op(OpSpec(
        name="nn.functional.square_error_cost",
        fn=F.square_error_cost,
        ref=lambda a, b: (a - b) ** 2,
        sample=lambda rng: (_r(rng, 3, 4), _r(rng, 3, 4)),
        grad_wrt=(0, 1)))
    register_op(OpSpec(
        name="nn.functional.binary_cross_entropy_with_logits",
        fn=lambda lg, lb: F.binary_cross_entropy_with_logits(lg, lb),
        ref=lambda lg, lb: np.mean(
            np.maximum(lg, 0) - lg * lb + np.log1p(np.exp(-np.abs(lg)))),
        sample=lambda rng: (_r(rng, 3, 4),
                            (rng.rand(3, 4) > 0.5).astype(np.float32)),
        grad_wrt=(0,)))
    register_op(OpSpec(
        name="nn.functional.nll_loss",
        fn=lambda lp, lb: F.nll_loss(lp, lb),
        ref=lambda lp, lb: -np.mean(lp[np.arange(lp.shape[0]), lb]),
        sample=lambda rng: (np.log(_np_softmax(_r(rng, 5, 6))),
                            _ints(rng, 0, 6, 5)),
        grad_wrt=(0,)))
    register_op(OpSpec(
        name="nn.functional.pairwise_distance",
        fn=lambda a, b: F.pairwise_distance(a, b),
        ref=lambda a, b: np.linalg.norm(a - b + 1e-6, axis=1),
        sample=lambda rng: (_r(rng, 3, 5), _r(rng, 3, 5)),
        grad_wrt=(0, 1), rtol=1e-4, atol=1e-4))
    register_op(OpSpec(
        name="nn.functional.margin_ranking_loss",
        fn=lambda a, b, y: F.margin_ranking_loss(a, b, y, margin=0.2),
        ref=lambda a, b, y: np.mean(np.maximum(0, -y * (a - b) + 0.2)),
        sample=lambda rng: (_r(rng, 6), _r(rng, 6),
                            np.sign(_r(rng, 6)).astype(np.float32)),
        grad_wrt=(0, 1)))
    register_op(OpSpec(
        name="nn.functional.hinge_embedding_loss",
        fn=lambda x, y: F.hinge_embedding_loss(x, y),
        ref=lambda x, y: np.mean(np.where(
            y == 1, x, np.maximum(0, 1.0 - x))),
        sample=lambda rng: (_pos(rng, 6),
                            np.where(rng.rand(6) > 0.5, 1.0,
                                     -1.0).astype(np.float32)),
        grad_wrt=(0,)))
    register_op(OpSpec(
        name="nn.functional.triplet_margin_loss",
        fn=lambda a, p, n: F.triplet_margin_loss(a, p, n),
        ref=lambda a, p, n: np.mean(np.maximum(
            np.sqrt(np.sum((a - p) ** 2, 1) + 1e-6)
            - np.sqrt(np.sum((a - n) ** 2, 1) + 1e-6) + 1.0, 0)),
        sample=lambda rng: (_r(rng, 4, 5), _r(rng, 4, 5), _r(rng, 4, 5)),
        grad_wrt=(0,), rtol=1e-4, atol=1e-4))
    register_op(OpSpec(
        name="nn.functional.cosine_embedding_loss",
        fn=lambda a, b, y: F.cosine_embedding_loss(a, b, y),
        ref=_np_cosine_embedding_loss,
        sample=lambda rng: (_r(rng, 4, 5), _r(rng, 4, 5),
                            np.where(np.random.RandomState(3).rand(4) > 0.5,
                                     1.0, -1.0).astype(np.float32)),
        grad_wrt=(0, 1), rtol=1e-4, atol=1e-4))

    # -- signal (reference python/paddle/signal.py) ------------------------
    register_op(OpSpec(
        name="signal.frame",
        fn=lambda x: pt.signal.frame(x, 4, 2),
        ref=lambda x: np.stack([x[..., i * 2:i * 2 + 4]
                                for i in range((x.shape[-1] - 4) // 2 + 1)],
                               axis=-1),
        sample=lambda rng: (_r(rng, 2, 12),), grad_wrt=(0,)))
    register_op(OpSpec(
        name="signal.overlap_add",
        fn=lambda x: pt.signal.overlap_add(x, 2),
        ref=_np_overlap_add_hop2,
        sample=lambda rng: (_r(rng, 4, 3),), grad_wrt=(0,)))
    register_op(OpSpec(
        name="signal.stft",
        fn=lambda x: pt.signal.stft(x, n_fft=16, hop_length=8),
        ref=lambda x: _np_stft(x, 16, 8),
        sample=lambda rng: (_r(rng, 64),), grad_wrt=(),
        rtol=1e-4, atol=1e-4, bf16=False))

    # -- complex-number surface -------------------------------------------
    register_op(OpSpec(
        name="complex", fn=pt.complex,
        ref=lambda re, im: re + 1j * im,
        sample=lambda rng: (_r(rng, 3, 4), _r(rng, 3, 4)),
        grad_wrt=(), bf16=False))
    register_op(OpSpec(
        name="real", fn=pt.real, ref=np.real,
        sample=lambda rng: (_r(rng, 3, 4) + 1j * _r(rng, 3, 4),),
        grad_wrt=()))
    register_op(OpSpec(
        name="imag", fn=pt.imag, ref=np.imag,
        sample=lambda rng: (_r(rng, 3, 4) + 1j * _r(rng, 3, 4),),
        grad_wrt=()))
    register_op(OpSpec(
        name="conj", fn=pt.conj, ref=np.conj,
        sample=lambda rng: (_r(rng, 3, 4) + 1j * _r(rng, 3, 4),),
        grad_wrt=()))
    register_op(OpSpec(
        name="angle", fn=pt.angle, ref=np.angle,
        sample=lambda rng: (_r(rng, 3, 4) + 1j * _r(rng, 3, 4),),
        grad_wrt=(), rtol=1e-4, atol=1e-5))

    def _np_linear_ce(hid, table, lab):
        logits = np.einsum("bsh,vh->bsv", hid.astype(np.float64),
                           table.astype(np.float64))
        m = logits.max(-1, keepdims=True)
        lse = (m[..., 0] + np.log(np.exp(logits - m).sum(-1)))
        picked = np.take_along_axis(logits, lab[..., None], -1)[..., 0]
        return np.mean(lse - picked)

    def _lce_sample(rng):
        hid = (_r(rng, 1, 128, 4) * 0.5).astype(np.float32)
        table = (_r(rng, 17, 4) * 0.5).astype(np.float32)
        lab = rng.randint(0, 17, (1, 128)).astype(np.int32)
        return (hid, table, lab)

    from .fused import linear_softmax_cross_entropy as _lce
    register_op(OpSpec(
        name="ops.fused.linear_softmax_cross_entropy",
        fn=lambda h, w, l: _lce(h, w, l),       # s=128 -> fused chunked path
        ref=_np_linear_ce,
        sample=_lce_sample,
        # numeric-grad only the small table arg (finite differences over the
        # [1,128,4] hidden would dominate the sweep's wall-clock); the
        # hidden gradient is analytically parity-checked against the
        # unfused reference in tests/test_ops.py::TestLinearCrossEntropy
        grad_wrt=(1,), rtol=1e-4, atol=1e-5))

    _populate_session3(unary, binary)


def _populate_session3(unary, binary) -> None:
    """The __all__-parity corpus (activation tail, N-D pools, unfold /
    fold, loss family, segment ops).  grid_sample / affine_grid have no
    entry: their numpy oracle would be the op itself."""

    import paddle_tpu_torch as pt
    import paddle_tpu_torch.incubate as inc
    from paddle_tpu_torch.nn import functional as F

    # -- activation tail ---------------------------------------------------
    unary("nn.functional.celu", lambda x: F.celu(x, 1.0),
          lambda x: np.maximum(x, 0) + np.minimum(np.expm1(x), 0))
    unary("nn.functional.selu", F.selu,
          lambda x: 1.0507009873554805 * np.where(
              x > 0, x, 1.6732632423543772 * np.expm1(x)))
    unary("nn.functional.softsign", F.softsign,
          lambda x: x / (1 + np.abs(x)))
    unary("nn.functional.softshrink", lambda x: F.softshrink(x, 0.5),
          lambda x: np.where(x > 0.5, x - 0.5,
                             np.where(x < -0.5, x + 0.5, 0.0)))
    unary("nn.functional.hardshrink", F.hardshrink,
          lambda x: np.where(np.abs(x) > 0.5, x, 0.0))
    unary("nn.functional.hardtanh", F.hardtanh,
          lambda x: np.clip(x, -1, 1))
    unary("nn.functional.tanhshrink", F.tanhshrink,
          lambda x: x - np.tanh(x))
    unary("nn.functional.thresholded_relu", F.thresholded_relu,
          lambda x: np.where(x > 1.0, x, 0.0))
    unary("nn.functional.log_sigmoid", F.log_sigmoid,
          lambda x: -np.log1p(np.exp(-x)))
    unary("nn.functional.maxout", lambda x: F.maxout(x, 2),
          lambda x: x.reshape(3, 2, 2, 4).max(axis=2),
          sample=lambda rng: (_r(rng, 3, 4, 4),))

    # -- math tail ---------------------------------------------------------
    unary("lgamma", pt.lgamma, np.vectorize(_lgamma_scalar),
          sample=lambda rng: (_pos(rng, 3, 4),))
    unary("asinh", pt.asinh, np.arcsinh)
    unary("acosh", pt.acosh, np.arccosh,
          sample=lambda rng: (_pos(rng, 3, 4) + 1.0,))
    unary("atanh", pt.atanh, np.arctanh,
          # tanh-bounded sample keeps every draw inside arctanh's (-1, 1)
          # domain for any harness seed
          sample=lambda rng: (np.tanh(_r(rng, 3, 4)) * 0.95,))
    binary("floor_mod", pt.floor_mod, np.mod,
           sample=lambda rng: (_pos(rng, 3, 4), _pos(rng, 3, 4)),
           grad_wrt=())
    register_op(OpSpec(
        name="add_n",
        fn=lambda a, b, c: pt.add_n([a, b, c]),
        ref=lambda a, b, c: a + b + c,
        sample=lambda rng: (_r(rng, 3, 4), _r(rng, 3, 4), _r(rng, 3, 4)),
        grad_wrt=(0, 1, 2)))

    # -- manipulation tail -------------------------------------------------
    unary("reverse", lambda x: pt.reverse(x, [1]),
          lambda x: x[:, ::-1], sample=lambda rng: (_r(rng, 3, 4),))
    unary("slice", lambda x: pt.slice(x, [1], [1], [3]),
          lambda x: x[:, 1:3], sample=lambda rng: (_r(rng, 3, 4),))
    unary("strided_slice", lambda x: pt.strided_slice(x, [1], [0], [4], [2]),
          lambda x: x[:, 0:4:2], sample=lambda rng: (_r(rng, 3, 4),))
    unary("crop", lambda x: pt.crop(x, shape=[2, -1], offsets=[1, 0]),
          lambda x: x[1:3], sample=lambda rng: (_r(rng, 4, 3),))
    register_op(OpSpec(
        name="scatter_nd_add",
        fn=lambda x, u: pt.scatter_nd_add(
            x, np.array([[1], [1], [3]]), u),
        ref=lambda x, u: _np_scatter_nd_add(x, np.array([[1], [1], [3]]), u),
        sample=lambda rng: (_r(rng, 5), _r(rng, 3)),
        grad_wrt=(0, 1)))
    register_op(OpSpec(
        name="shard_index",
        fn=lambda: pt.shard_index(
            np.array([1, 9, 10, 19], np.int64), 20, 2, 0),
        ref=lambda: np.array([1, 9, -1, -1], np.int64),
        sample=lambda rng: (),
        grad_wrt=(), bf16=False))

    # -- pooling / shape ---------------------------------------------------
    register_op(OpSpec(
        name="nn.functional.max_pool3d",
        fn=lambda x: F.max_pool3d(x, 2),
        ref=lambda x: x.reshape(1, 2, 2, 2, 2, 2, 2, 2).max(axis=(3, 5, 7)),
        sample=lambda rng: (_r(rng, 1, 2, 4, 4, 4),)))
    register_op(OpSpec(
        name="nn.functional.avg_pool3d",
        fn=lambda x: F.avg_pool3d(x, 2),
        ref=lambda x: x.reshape(1, 2, 2, 2, 2, 2, 2, 2).mean(axis=(3, 5, 7)),
        sample=lambda rng: (_r(rng, 1, 2, 4, 4, 4),)))
    register_op(OpSpec(
        name="nn.functional.adaptive_avg_pool1d",
        fn=lambda x: F.adaptive_avg_pool1d(x, 5),
        ref=lambda x: x.reshape(2, 3, 5, 2).mean(-1),
        sample=lambda rng: (_r(rng, 2, 3, 10),)))
    register_op(OpSpec(
        name="nn.functional.unfold",
        fn=lambda x: F.unfold(x, 2, 2),
        ref=_np_unfold_2x2,
        sample=lambda rng: (_r(rng, 2, 3, 4, 4),)))
    register_op(OpSpec(
        name="nn.functional.fold",
        fn=lambda u: F.fold(u, (4, 4), 2, 2),
        ref=_np_fold_2x2,
        sample=lambda rng: (_r(rng, 2, 12, 4),)))
    register_op(OpSpec(
        name="nn.functional.zeropad2d",
        fn=lambda x: F.zeropad2d(x, [1, 2, 0, 1]),
        ref=lambda x: np.pad(x, ((0, 0), (0, 0), (0, 1), (1, 2))),
        sample=lambda rng: (_r(rng, 2, 2, 3, 3),)))

    # -- norm / vision -----------------------------------------------------
    register_op(OpSpec(
        name="nn.functional.local_response_norm",
        fn=lambda x: F.local_response_norm(x, size=3, alpha=1e-2,
                                           beta=0.5, k=1.0),
        ref=lambda x: _np_lrn(x, 3, 1e-2, 0.5, 1.0),
        # keep samples off 0: |x| kinks there and the centered numeric
        # grad picks up the kink noise
        sample=lambda rng: (_pos(rng, 2, 5, 3, 3),),
        grad_rtol=2e-2, grad_atol=2e-3))
    register_op(OpSpec(
        name="nn.functional.instance_norm",
        fn=F.instance_norm,
        ref=lambda x: (x - x.mean(axis=(2, 3), keepdims=True))
        / np.sqrt(x.var(axis=(2, 3), keepdims=True) + 1e-5),
        sample=lambda rng: (_r(rng, 2, 3, 5, 5),), rtol=1e-4,
        grad_rtol=2e-2, grad_atol=2e-3))
    register_op(OpSpec(
        name="nn.functional.bilinear",
        fn=F.bilinear,
        ref=lambda a, b, w: np.einsum("ni,oij,nj->no", a, w, b),
        sample=lambda rng: (_r(rng, 3, 2), _r(rng, 3, 4), _r(rng, 5, 2, 4)),
        grad_wrt=(0, 1, 2)))
    register_op(OpSpec(
        name="nn.functional.temporal_shift",
        fn=lambda x: F.temporal_shift(x, 2, 0.25),
        ref=lambda x: _np_temporal_shift(x, 2, 0.25),
        sample=lambda rng: (_r(rng, 4, 8, 2, 2),)))

    # -- losses ------------------------------------------------------------
    register_op(OpSpec(
        name="nn.functional.binary_cross_entropy",
        fn=F.binary_cross_entropy,
        ref=lambda p, y: float(np.mean(
            -(y * np.log(p) + (1 - y) * np.log(1 - p)))),
        sample=lambda rng: (
            (rng.rand(8) * 0.8 + 0.1).astype(np.float32),
            rng.randint(0, 2, 8).astype(np.float32)),
        grad_wrt=(0,), rtol=1e-4))
    register_op(OpSpec(
        name="nn.functional.log_loss",
        fn=lambda p, y: F.log_loss(p, y, 1e-4),
        ref=lambda p, y: -(y * np.log(p + 1e-4)
                           + (1 - y) * np.log(1 - p + 1e-4)),
        sample=lambda rng: (
            (rng.rand(8) * 0.8 + 0.1).astype(np.float32),
            rng.randint(0, 2, 8).astype(np.float32)),
        grad_wrt=(0,), rtol=1e-4))
    register_op(OpSpec(
        name="nn.functional.sigmoid_focal_loss",
        fn=lambda x, y: F.sigmoid_focal_loss(x, y, reduction="sum"),
        ref=_np_focal,
        sample=lambda rng: (_r(rng, 8), rng.randint(0, 2, 8).astype(
            np.float32)),
        grad_wrt=(0,), rtol=1e-4))
    register_op(OpSpec(
        name="nn.functional.softmax_with_cross_entropy",
        fn=lambda x, y: F.softmax_with_cross_entropy(x, y),
        ref=lambda x, y: -np.log(
            _np_softmax(x))[np.arange(4), y][:, None],
        sample=lambda rng: (_r(rng, 4, 7),
                            rng.randint(0, 7, 4).astype(np.int32)),
        grad_wrt=(0,), rtol=1e-4))

    # -- segment ops (incubate) --------------------------------------------
    seg_ids = np.array([0, 0, 1, 2, 2], np.int32)
    register_op(OpSpec(
        name="incubate.segment_sum",
        fn=lambda x: inc.segment_sum(x, seg_ids),
        ref=lambda x: np.stack([x[:2].sum(0), x[2], x[3:].sum(0)]),
        sample=lambda rng: (_r(rng, 5, 3),)))
    register_op(OpSpec(
        name="incubate.segment_mean",
        fn=lambda x: inc.segment_mean(x, seg_ids),
        ref=lambda x: np.stack([x[:2].mean(0), x[2], x[3:].mean(0)]),
        sample=lambda rng: (_r(rng, 5, 3),)))
    register_op(OpSpec(
        name="incubate.segment_max",
        fn=lambda x: inc.segment_max(x, seg_ids),
        ref=lambda x: np.stack([x[:2].max(0), x[2], x[3:].max(0)]),
        sample=lambda rng: (_r(rng, 5, 3),), grad_wrt=()))
    register_op(OpSpec(
        name="incubate.segment_min",
        fn=lambda x: inc.segment_min(x, seg_ids),
        ref=lambda x: np.stack([x[:2].min(0), x[2], x[3:].min(0)]),
        sample=lambda rng: (_r(rng, 5, 3),), grad_wrt=()))



def _nan_sample(rng):
    x = _r(rng, 3, 5)
    x[0, 1] = np.nan
    x[2, 3] = np.nan
    return (x,)


def _np_overlap_add_hop2(x):
    fl, nf = x.shape
    out = np.zeros((nf - 1) * 2 + fl, x.dtype)
    for j in range(nf):
        out[j * 2:j * 2 + fl] += x[:, j]
    return out


def _np_stft(x, n_fft, hop):
    pad = n_fft // 2
    xp = np.pad(x, (pad, pad), mode="reflect")
    nf = 1 + (len(xp) - n_fft) // hop
    frames = np.stack([xp[i * hop:i * hop + n_fft] for i in range(nf)], -1)
    return np.fft.rfft(frames, axis=0)


def _np_mode_rows(x):
    """Most frequent value per row; ties resolve to the LARGEST value
    (mode_op semantics, matching tensor_ops.mode)."""
    out = []
    for r in x:
        vals, counts = np.unique(r, return_counts=True)
        best = vals[counts == counts.max()]
        out.append(best.max())
    return np.asarray(out, x.dtype)


def _np_put_along_axis(x, i, v):
    out = x.copy()
    np.put_along_axis(out, i, v, axis=1)
    return out


def _np_scatter_overwrite(x, index, updates):
    out = x.copy()
    out[index] = updates
    return out


def _np_renorm(x, p=2.0, axis=0, max_norm=1.0):
    # slice i along `axis` scaled so its p-norm is <= max_norm
    out = x.copy()
    norms = np.linalg.norm(x.reshape(x.shape[0], -1) if axis == 0 else x,
                           axis=1 if axis == 0 else axis)
    for i in range(x.shape[axis]):
        n = norms[i]
        if n > max_norm:
            out[i] = x[i] * (max_norm / n)
    return out


def _np_adaptive_pool(x, out, reduce):
    n, c, h, w = x.shape
    res = np.zeros((n, c, out, out), x.dtype)
    for i in range(out):
        for j in range(out):
            hs, he = (i * h) // out, -(-((i + 1) * h) // out)
            ws, we = (j * w) // out, -(-((j + 1) * w) // out)
            res[:, :, i, j] = reduce(x[:, :, hs:he, ws:we], axis=(2, 3))
    return res


def _np_conv2d(x, w, pad=0):
    n, cin, h, wd = x.shape
    cout, _, kh, kw = w.shape
    xp = np.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    oh, ow = h + 2 * pad - kh + 1, wd + 2 * pad - kw + 1
    out = np.zeros((n, cout, oh, ow), np.float64)
    for i in range(oh):
        for j in range(ow):
            patch = xp[:, :, i:i + kh, j:j + kw]
            out[:, :, i, j] = np.einsum("ncij,ocij->no", patch, w)
    return out


def _np_pixel_shuffle(x):
    n, c, h, w = x.shape
    r = 2
    y = x.reshape(n, c // (r * r), r, r, h, w)
    return y.transpose(0, 1, 4, 2, 5, 3).reshape(n, c // (r * r),
                                                 h * r, w * r)


def _np_pixel_unshuffle(x, r):
    n, c, h, w = x.shape
    y = x.reshape(n, c, h // r, r, w // r, r)
    return y.transpose(0, 1, 3, 5, 2, 4).reshape(n, c * r * r,
                                                 h // r, w // r)


def _np_group_norm(x, groups, eps):
    n, c, h, w = x.shape
    y = x.reshape(n, groups, c // groups, h, w)
    mu = y.mean(axis=(2, 3, 4), keepdims=True)
    var = y.var(axis=(2, 3, 4), keepdims=True)
    return ((y - mu) / np.sqrt(var + eps)).reshape(x.shape)


def _np_causal_softmax(x):
    s, t = x.shape[-2], x.shape[-1]
    mask = np.triu(np.ones((s, t), bool), k=1)
    xm = np.where(mask, -1e9, x)
    return _np_softmax(xm)


def _np_cosine_embedding_loss(a, b, y, margin=0.0):
    cos = np.sum(a * b, 1) / np.maximum(
        np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1), 1e-12)
    loss = np.where(y == 1, 1 - cos, np.maximum(0, cos - margin))
    return np.mean(loss)


def _erf_scalar(x: float) -> float:
    import math
    return math.erf(float(x))


def _lgamma_scalar(x: float) -> float:
    import math
    return math.lgamma(float(x))


def _digamma_scalar(x: float) -> float:
    """psi(x) for x > 0: the recurrence psi(x) = psi(x + 1) - 1/x up to
    x >= 6, then the asymptotic series (error below 1e-12 there) — a
    dependency-free numpy reference."""
    import math
    x, acc = float(x), 0.0
    while x < 6.0:
        acc -= 1.0 / x
        x += 1.0
    inv2 = 1.0 / (x * x)
    return acc + math.log(x) - 0.5 / x - inv2 * (
        1 / 12 - inv2 * (1 / 120 - inv2 * (1 / 252 - inv2 * (
            1 / 240 - inv2 * (5 / 660)))))


def _erfinv_scalar(y: float) -> float:
    # bisection on erf — dependency-free numpy reference
    import math
    lo, hi = -6.0, 6.0
    for _ in range(80):
        mid = (lo + hi) / 2
        if math.erf(mid) < y:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def _np_softmax(x):
    e = np.exp(x - np.max(x, axis=-1, keepdims=True))
    return e / np.sum(e, axis=-1, keepdims=True)


def _np_layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdims=True)
    var = x.var(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + eps) * w + b


def _np_scatter_nd_add(x, idx, u):
    out = x.copy()
    for i, j in enumerate(idx[:, 0]):
        out[j] += u[i]
    return out


def _np_unfold_2x2(x):
    n, c, h, w = x.shape
    cols = []
    for i in range(0, h, 2):
        for j in range(0, w, 2):
            cols.append(x[:, :, i:i + 2, j:j + 2].reshape(n, c * 4))
    return np.stack(cols, axis=-1)


def _np_fold_2x2(u):
    n, ckk, L = u.shape
    c = ckk // 4
    hw = int(np.sqrt(L)) * 2
    out = np.zeros((n, c, hw, hw), u.dtype)
    col = 0
    for i in range(0, hw, 2):
        for j in range(0, hw, 2):
            out[:, :, i:i + 2, j:j + 2] += u[:, :, col].reshape(n, c, 2, 2)
            col += 1
    return out


def _np_lrn(x, size, alpha, beta, k):
    n, c, h, w = x.shape
    acc = np.zeros_like(x)
    lo = (size - 1) // 2
    for ci in range(c):
        a, b = max(0, ci - lo), min(c, ci + (size - 1 - lo) + 1)
        acc[:, ci] = (x[:, a:b] ** 2).sum(1)
    return x / (k + alpha / size * acc) ** beta


def _np_temporal_shift(x, seg, ratio):
    nt, c, h, w = x.shape
    n = nt // seg
    xr = x.reshape(n, seg, c, h, w)
    c1 = int(c * ratio)
    c2 = int(c * 2 * ratio)
    out = np.zeros_like(xr)
    out[:, :-1, :c1] = xr[:, 1:, :c1]
    out[:, 1:, c1:c2] = xr[:, :-1, c1:c2]
    out[:, :, c2:] = xr[:, :, c2:]
    return out.reshape(nt, c, h, w)


def _np_focal(x, y, alpha=0.25, gamma=2.0):
    p = 1 / (1 + np.exp(-x))
    ce = np.maximum(x, 0) - x * y + np.log1p(np.exp(-np.abs(x)))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    return float(np.sum(a_t * (1 - p_t) ** gamma * ce))
