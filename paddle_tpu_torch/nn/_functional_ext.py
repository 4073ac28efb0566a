"""The long tail of the functional surface: the port of
``paddle_tpu/nn/_functional_ext.py`` (all but ``gather_tree``, which
``functional.py`` holds), re-exported by :mod:`.functional`.

Plain PyTorch, as the JAX module is plain XLA: windowed reductions are
torch's pools, im2col / col2im are ``unfold`` / ``fold``, the rest
gathers, scatters and elementwise ops.  The JAX semantics are kept where
torch's own differ: clipped activations are ``maximum`` / ``minimum``
compositions (a gradient of 0.5 at a tie, as JAX's), the average pools
divide by the in-bounds count, ``max_unpool*`` scatters into a zero
plane.  Random ops (the channel dropouts, ``alpha_dropout``,
``gumbel_softmax``) draw from an explicit ``torch.Generator``: the one
given, else the device's stream of ``framework/random.py``.  The JAX
package's threefry bits are not reproduced, only the distributions.
``class_center_sample`` and ``hsigmoid_loss``'s default tree are host
numpy, as in JAX, so equal seeds give equal samples.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as TF

from ..framework import random as fw_random
from ..framework.errors import enforce
from . import functional as F
from .functional import _clip, _ntuple, _reduce

__all__ = [
    # activations
    "celu", "elu_", "hardshrink", "hardtanh", "log_sigmoid", "maxout",
    "relu_", "selu", "softmax_", "softshrink", "softsign", "tanh_",
    "tanhshrink", "thresholded_relu", "gumbel_softmax",
    # conv
    "conv1d_transpose", "conv3d_transpose",
    # common / extension
    "diag_embed", "sequence_mask", "dropout2d", "dropout3d",
    "alpha_dropout", "zeropad2d", "unfold", "fold", "upsample", "bilinear",
    "temporal_shift",
    # pooling
    "avg_pool3d", "max_pool3d", "max_unpool1d", "max_unpool2d",
    "max_unpool3d", "adaptive_avg_pool1d", "adaptive_avg_pool3d",
    "adaptive_max_pool1d", "adaptive_max_pool3d",
    # losses
    "binary_cross_entropy", "dice_loss", "hsigmoid_loss", "log_loss",
    "npair_loss", "sigmoid_focal_loss", "softmax_with_cross_entropy",
    "margin_cross_entropy", "class_center_sample",
    # norm
    "local_response_norm", "instance_norm",
    # vision
    "affine_grid", "grid_sample",
]


def _f32(t):
    """float32, the dtype the JAX ops compute these in; float64 stays
    float64 (the JAX package runs without float64, so it has no rule
    for it, and a float64 run on the card checks the float32 one)."""
    return t if t.dtype == torch.float64 else t.float()


def _gen(x, generator):
    return generator if generator is not None else fw_random.generator(
        x.device)


# ---------------------------------------------------------------------------
# Activations (_functional_ext.py:66-159)
# ---------------------------------------------------------------------------
def celu(x, alpha: float = 1.0):
    enforce(alpha != 0, "celu alpha must be non-zero")
    neg = alpha * torch.expm1(x / alpha)
    return (torch.maximum(x, x.new_zeros(()))
            + torch.minimum(neg, neg.new_zeros(()))).to(x.dtype)


def selu(x, scale: float = 1.0507009873554805,
         alpha: float = 1.6732632423543772):
    return (scale * torch.where(x > 0, x, alpha * torch.expm1(x))).to(
        x.dtype)


def softsign(x):
    return x / (1 + x.abs())


def softshrink(x, threshold: float = 0.5):
    zero = x.new_zeros(())
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def hardshrink(x, threshold: float = 0.5):
    return torch.where(x.abs() > threshold, x, x.new_zeros(()))


def hardtanh(x, min: float = -1.0, max: float = 1.0):  # noqa: A002
    return _clip(x, min, max)


def tanhshrink(x):
    return x - torch.tanh(x)


def thresholded_relu(x, threshold: float = 1.0):
    return torch.where(x > threshold, x, x.new_zeros(()))


def log_sigmoid(x):
    return TF.logsigmoid(x)


def maxout(x, groups: int, axis: int = 1):
    """Max over ``groups`` consecutive channel slices."""
    if axis < 0:
        axis += x.dim()
    c = x.shape[axis]
    enforce(c % groups == 0,
            f"maxout: channels {c} not divisible by groups {groups}")
    shape = tuple(x.shape[:axis]) + (c // groups, groups) + tuple(
        x.shape[axis + 1:])
    return x.reshape(shape).amax(dim=axis + 1)


def gumbel_softmax(x, temperature: float = 1.0, hard: bool = False,
                   axis: int = -1,
                   generator: Optional[torch.Generator] = None):
    """softmax((x + g) / temperature) with g = -log(-log(u)), u uniform in
    [1e-20, 1) in float32; ``hard`` gives the one-hot of each argmax with
    the soft sample's gradient (straight through)."""
    u = torch.rand(x.shape, generator=_gen(x, generator), device=x.device)
    u = 1e-20 + (1.0 - 1e-20) * u
    g = -torch.log(-torch.log(u))
    y = torch.softmax((_f32(x) + g.to(_f32(x).dtype)) / temperature, dim=axis)
    if hard:
        onehot = torch.zeros_like(y).scatter_(
            axis, y.argmax(dim=axis, keepdim=True), 1.0)
        y = onehot + y - y.detach()
    return y.to(x.dtype)


# in place, as the reference's trailing-underscore ops: x is overwritten
# and returned
def relu_(x):
    return torch.relu_(x)


def elu_(x, alpha: float = 1.0):
    return TF.elu_(x, alpha)


def tanh_(x):
    return x.tanh_()


def softmax_(x, axis: int = -1):
    return x.copy_(torch.softmax(x, dim=axis))


# ---------------------------------------------------------------------------
# Transposed convolutions (_functional_ext.py:198-218)
# ---------------------------------------------------------------------------
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups: int = 1, dilation=1,
                     data_format: str = "NCL"):
    """(N, C, L) (or NLC) transposed convolution; weight (in, out / groups,
    k)."""
    enforce(data_format in ("NCL", "NLC"),
            f"unknown data_format {data_format!r}")
    return F._conv_transpose(x, weight, bias, stride, padding,
                             output_padding, dilation, groups, 1,
                             data_format == "NLC")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups: int = 1, dilation=1,
                     data_format: str = "NCDHW"):
    """(N, C, D, H, W) (or NDHWC) transposed convolution; weight (in,
    out / groups, kd, kh, kw)."""
    enforce(data_format in ("NCDHW", "NDHWC"),
            f"unknown data_format {data_format!r}")
    return F._conv_transpose(x, weight, bias, stride, padding,
                             output_padding, dilation, groups, 3,
                             data_format == "NDHWC")


# ---------------------------------------------------------------------------
# Common / extension (_functional_ext.py:224-385)
# ---------------------------------------------------------------------------
def diag_embed(input, offset: int = 0, dim1: int = -2,  # noqa: A002
               dim2: int = -1):
    """The last dim as the ``offset`` diagonal of new square matrices on
    dims (dim1, dim2)."""
    return torch.diag_embed(input, offset, dim1, dim2)


def _dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def sequence_mask(x, maxlen: Optional[int] = None, dtype="int64"):
    """(..., maxlen) mask of position < length; without ``maxlen`` the
    largest length, read back from the device."""
    if maxlen is None:
        maxlen = int(x.max())
    pos = torch.arange(maxlen, device=x.device)
    return (pos < x[..., None]).to(_dtype(dtype))


def _dropout_channels(x, p, training, ndim_spatial, generator):
    enforce(x.dim() == 2 + ndim_spatial,
            f"expected {2 + ndim_spatial}-D input, got {x.dim()}-D")
    if not training or p == 0.0:
        return x
    keep = torch.rand(tuple(x.shape[:2]), generator=_gen(x, generator),
                      device=x.device) < 1.0 - p
    keep = keep.reshape(keep.shape + (1,) * ndim_spatial)
    return torch.where(keep, x / (1.0 - p), x.new_zeros(())).to(x.dtype)


def dropout2d(x, p: float = 0.5, training: bool = True,
              data_format: str = "NCHW",
              generator: Optional[torch.Generator] = None):
    """Drop whole channels of a 4-D tensor, keep rate 1 - p, upscaled."""
    enforce(data_format == "NCHW", "dropout2d supports NCHW")
    return _dropout_channels(x, p, training, 2, generator)


def dropout3d(x, p: float = 0.5, training: bool = True,
              data_format: str = "NCDHW",
              generator: Optional[torch.Generator] = None):
    enforce(data_format == "NCDHW", "dropout3d supports NCDHW")
    return _dropout_channels(x, p, training, 3, generator)


def alpha_dropout(x, p: float = 0.5, training: bool = True,
                  generator: Optional[torch.Generator] = None):
    """SELU-preserving dropout: dropped units go to -alpha' = -scale x
    alpha of SELU, then ``a x + b`` restores zero mean and unit variance
    of a standard input."""
    if not training or p == 0.0:
        return x
    neg = -1.6732632423543772 * 1.0507009873554805
    a = (1 - p + p * neg ** 2) ** -0.5
    b = -a * p * neg
    keep = torch.rand(x.shape, generator=_gen(x, generator),
                      device=x.device) < 1.0 - p
    return (a * torch.where(keep, x, x.new_full((), neg)) + b).to(x.dtype)


def zeropad2d(x, padding, data_format: str = "NCHW"):
    """``padding`` = (left, right, top, bottom)."""
    l, r, t, b = _ntuple(padding, 4)
    if data_format == "NCHW":
        return TF.pad(x, (l, r, t, b))
    return TF.pad(x, (0, 0, l, r, t, b))


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col: (N, C, H, W) -> (N, C kh kw, L), channel slowest."""
    return TF.unfold(x, _ntuple(kernel_sizes, 2), _ntuple(dilations, 2),
                     _ntuple(paddings, 2), _ntuple(strides, 2))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0,
         dilations=1):
    """col2im, the scatter-add inverse of :func:`unfold`."""
    oh, ow = _ntuple(output_sizes, 2)
    kh, kw = _ntuple(kernel_sizes, 2)
    s, p, d = _ntuple(strides, 2), _ntuple(paddings, 2), _ntuple(
        dilations, 2)
    nh = (oh + 2 * p[0] - d[0] * (kh - 1) - 1) // s[0] + 1
    nw = (ow + 2 * p[1] - d[1] * (kw - 1) - 1) // s[1] + 1
    enforce(nh * nw == x.shape[2],
            f"fold: {x.shape[2]} columns inconsistent with output {oh}x{ow}")
    return TF.fold(x, (oh, ow), (kh, kw), d, p, s)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, data_format="NCHW"):
    return F.interpolate(x, size=size, scale_factor=scale_factor,
                         mode=mode, align_corners=align_corners,
                         data_format=data_format)


def bilinear(x1, x2, weight, bias=None):
    """out[n, o] = x1[n] W[o] x2[n]; weight (out, in1, in2)."""
    y = torch.einsum("ni,oij,nj->no", x1, weight, x2)
    if bias is not None:
        y = y + bias.reshape(1, -1)
    return y


def temporal_shift(x, seg_num: int, shift_ratio: float = 0.25,
                   data_format: str = "NCHW"):
    """TSM's shift along the segment axis: the first ``shift_ratio`` of the
    channels move one segment back, the next ``shift_ratio`` one forward,
    the rest stay; vacated segments are zero."""
    enforce(data_format == "NCHW", "temporal_shift supports NCHW")
    nt, c, h, w = x.shape
    xr = x.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    back = torch.cat([xr[:, 1:, :c1], torch.zeros_like(xr[:, :1, :c1])],
                     dim=1)
    fwd = torch.cat([torch.zeros_like(xr[:, :1, c1:c2]), xr[:, :-1, c1:c2]],
                    dim=1)
    return torch.cat([back, fwd, xr[:, :, c2:]], dim=2).reshape(nt, c, h, w)


# ---------------------------------------------------------------------------
# Pooling (_functional_ext.py:391-516)
# ---------------------------------------------------------------------------
def _cf(x, channel_last: bool):
    return x.movedim(-1, 1) if channel_last else x


def _padded(x, k, p, value):
    """Padding above half the kernel (which torch's pools refuse) applied
    to ``x`` itself; returns ``(x, pad)`` for the pool."""
    if all(pi <= ki // 2 for pi, ki in zip(p, k)):
        return x, p
    widths = [v for pi in reversed(p) for v in (pi, pi)]
    return TF.pad(x, widths, value=value), (0,) * len(p)


def max_pool3d(x, kernel_size, stride=None, padding=0,
               data_format: str = "NCDHW"):
    """Max over windows, padding counting as -inf."""
    cl = data_format == "NDHWC"
    k = _ntuple(kernel_size, 3)
    s = _ntuple(stride if stride is not None else kernel_size, 3)
    xp, p = _padded(_cf(x, cl), k, _ntuple(padding, 3), float("-inf"))
    y = TF.max_pool3d(xp, k, s, p)
    return y.movedim(1, -1) if cl else y


def avg_pool3d(x, kernel_size, stride=None, padding=0,
               data_format: str = "NCDHW"):
    """Mean over windows, divided by the in-bounds count (a half-precision
    CPU tensor, which PyTorch's CPU pooling does not take, is pooled in
    float32 and rounded back)."""
    if x.device.type == "cpu" and x.dtype in (torch.bfloat16, torch.float16):
        return avg_pool3d(x.float(), kernel_size, stride, padding,
                          data_format).to(x.dtype)
    cl = data_format == "NDHWC"
    k = _ntuple(kernel_size, 3)
    s = _ntuple(stride if stride is not None else kernel_size, 3)
    xc = _cf(x, cl)
    xp, p = _padded(xc, k, _ntuple(padding, 3), 0.0)
    if xp is xc:
        y = TF.avg_pool3d(xc, k, s, p, count_include_pad=False)
    else:
        ones, _ = _padded(torch.ones_like(xc[:1, :1]), k,
                          _ntuple(padding, 3), 0.0)
        y = TF.avg_pool3d(xp, k, s) / TF.avg_pool3d(ones, k, s)
    return y.movedim(1, -1) if cl else y


def adaptive_avg_pool1d(x, output_size):
    """(N, C, L) -> (N, C, output_size); bin o covers [o L // out,
    ceil((o + 1) L / out)), the JAX bins."""
    return TF.adaptive_avg_pool1d(x, int(output_size))


def adaptive_max_pool1d(x, output_size, return_mask: bool = False):
    enforce(not return_mask, "return_mask unsupported on adaptive 1d")
    return TF.adaptive_max_pool1d(x, int(output_size))


def adaptive_avg_pool3d(x, output_size, data_format: str = "NCDHW"):
    enforce(data_format == "NCDHW", "adaptive_avg_pool3d supports NCDHW")
    return TF.adaptive_avg_pool3d(x, _ntuple(output_size, 3))


def adaptive_max_pool3d(x, output_size, data_format: str = "NCDHW"):
    enforce(data_format == "NCDHW", "adaptive_max_pool3d supports NCDHW")
    return TF.adaptive_max_pool3d(x, _ntuple(output_size, 3))


def _max_unpool(x, indices, nd, kernel_size, stride, padding, output_size):
    """Scatter each pooled value to its flat index in a zero plane of
    ``output_size`` (default (in - 1) s - 2 p + k a dim)."""
    k = _ntuple(kernel_size, nd)
    s = _ntuple(stride if stride is not None else kernel_size, nd)
    p = _ntuple(padding, nd)
    n, c = x.shape[0], x.shape[1]
    if output_size is None:
        out_sp = tuple((x.shape[2 + i] - 1) * s[i] - 2 * p[i] + k[i]
                       for i in range(nd))
    else:
        out_sp = _ntuple(output_size, nd)
    flat = int(np.prod(out_sp))
    out = x.new_zeros((n, c, flat)).scatter(
        2, indices.reshape(n, c, -1).long(), x.reshape(n, c, -1))
    return out.reshape(n, c, *out_sp)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format: str = "NCL"):
    enforce(data_format == "NCL", "max_unpool1d supports NCL")
    return _max_unpool(x, indices, 1, kernel_size, stride, padding,
                       output_size)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format: str = "NCHW"):
    """Scatter pooled values to their argmax positions (``indices`` as
    ``max_pool2d(return_mask=True)`` gives them, flat over the plane)."""
    enforce(data_format == "NCHW", "max_unpool2d supports NCHW")
    return _max_unpool(x, indices, 2, kernel_size, stride, padding,
                       output_size)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format: str = "NCDHW"):
    enforce(data_format == "NCDHW", "max_unpool3d supports NCDHW")
    return _max_unpool(x, indices, 3, kernel_size, stride, padding,
                       output_size)


# ---------------------------------------------------------------------------
# Losses (_functional_ext.py:531-708)
# ---------------------------------------------------------------------------
def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean"):
    """BCE on probabilities in float32, each log's argument clamped at
    1e-12."""
    x, y = _f32(input), _f32(label)
    eps = x.new_full((), 1e-12)
    loss = -(y * torch.log(torch.maximum(x, eps))
             + (1 - y) * torch.log(torch.maximum(1 - x, eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def dice_loss(input, label, epsilon: float = 1e-5):  # noqa: A002
    """1 - the dice coefficient of each sample's class probabilities (the
    last dim) against the one-hot of ``label`` (a trailing 1 allowed),
    averaged."""
    y = label[..., 0] if label.shape[-1] == 1 else label
    oh = TF.one_hot(y.long(), input.shape[-1]).to(input.dtype)
    red = tuple(range(1, input.dim()))
    inter = (input * oh).sum(dim=red)
    union = input.sum(dim=red) + oh.sum(dim=red)
    return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()


def log_loss(input, label, epsilon: float = 1e-4):  # noqa: A002
    x, y = _f32(input), _f32(label)
    return -(y * torch.log(x + epsilon) + (1 - y) * torch.log(
        1 - x + epsilon))


def npair_loss(anchor, positive, labels, l2_reg: float = 0.002):
    """Cross-entropy of anchor . positive^T against same-label targets,
    plus l2_reg / 4 x the mean squared norms of both embeddings."""
    a, p = _f32(anchor), _f32(positive)
    y = labels.reshape(-1)
    sim = a @ p.t()
    tgt = (y[:, None] == y[None, :]).to(a.dtype)
    tgt = tgt / tgt.sum(dim=1, keepdim=True)
    ce = -(tgt * torch.log_softmax(sim, dim=1)).sum(dim=1).mean()
    reg = l2_reg * ((a * a).sum(dim=1).mean()
                    + (p * p).sum(dim=1).mean()) * 0.25
    return ce + reg


def sigmoid_focal_loss(logit, label, normalizer=None, alpha: float = 0.25,
                       gamma: float = 2.0, reduction: str = "sum"):
    x, y = _f32(logit), _f32(label)
    p = torch.sigmoid(x)
    ce = (torch.maximum(x, x.new_zeros(())) - x * y
          + torch.log1p(torch.exp(-x.abs())))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label: bool = False,
                               ignore_index: int = -100,
                               numeric_stable_mode: bool = True,
                               return_softmax: bool = False,
                               axis: int = -1):
    """Per-sample loss with the class axis kept as a 1 (float32); labels
    equal to ``ignore_index`` count zero.  ``return_softmax`` also gives
    the softmax."""
    lsm = torch.log_softmax(_f32(logits), dim=axis)
    if soft_label:
        loss = -(_f32(label) * lsm).sum(dim=axis, keepdim=True)
    else:
        yi = label if label.dim() == logits.dim() else label.unsqueeze(axis)
        ignored = yi == ignore_index
        safe = torch.where(ignored, torch.zeros_like(yi), yi).long()
        nll = -lsm.gather(axis, safe)
        loss = torch.where(ignored, nll.new_zeros(()), nll)
    if return_softmax:
        return loss, torch.softmax(_f32(logits), dim=axis)
    return loss


def margin_cross_entropy(logits, label, margin1: float = 1.0,
                         margin2: float = 0.5, margin3: float = 0.0,
                         scale: float = 64.0, group=None,
                         return_softmax: bool = False,
                         reduction: Optional[str] = "mean"):
    """ArcFace / CosFace margins: the target cosine becomes cos(m1 theta +
    m2) - m3, every logit is scaled, then softmax cross-entropy (B, 1)
    reduced by ``reduction`` (None or "none" keeps it)."""
    x = _f32(logits)
    y = label.reshape(-1).long()
    cos_t = x.gather(1, y[:, None])
    theta = torch.arccos(_clip(cos_t, -1.0 + 1e-7, 1.0 - 1e-7))
    target = torch.cos(margin1 * theta + margin2) - margin3
    oh = TF.one_hot(y, x.shape[1]).to(x.dtype)
    adj = (x + oh * (target - cos_t)) * scale
    loss = -torch.log_softmax(adj, dim=1).gather(1, y[:, None])
    if reduction == "mean":
        loss = loss.mean()
    elif reduction == "sum":
        loss = loss.sum()
    if return_softmax:
        return loss, torch.softmax(adj, dim=1)
    return loss


def class_center_sample(label, num_classes: int, num_samples: int,
                        group=None, seed: Optional[int] = None):
    """The positives plus random negatives up to ``num_samples``, sorted,
    and each label remapped to its index among them: host numpy with
    ``RandomState(seed)`` (numpy's global stream draws the seed when
    None), the JAX op's draws exactly.  Returns int64 tensors on the
    label's device."""
    dev = label.device if torch.is_tensor(label) else torch.device("cpu")
    y = np.asarray(label.cpu() if torch.is_tensor(label) else label
                   ).reshape(-1)
    rng = np.random.RandomState(seed if seed is not None
                                else np.random.randint(2 ** 31))
    pos = np.unique(y)
    if len(pos) >= num_samples:
        sampled = pos
    else:
        rest = np.setdiff1d(np.arange(num_classes), pos,
                            assume_unique=False)
        rng.shuffle(rest)
        sampled = np.concatenate([pos, rest[:num_samples - len(pos)]])
    sampled = np.sort(sampled)
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(len(sampled))
    return (torch.from_numpy(remap[y]).to(dev),
            torch.from_numpy(sampled.astype(np.int64)).to(dev))


def _heap_paths(labels, num_classes: int):
    """The default tree's (node row, branch) paths: leaf l at heap
    position l + num_classes, internal node k's parameters at row k - 1,
    padded with -1 / 0 to ceil(log2 C) + 1."""
    depth = int(np.ceil(np.log2(num_classes))) + 1
    tables, codes = [], []
    for leaf in labels:
        node = int(leaf) + num_classes
        t, c = [], []
        while node > 1:
            t.append(node // 2 - 1)
            c.append(node % 2)
            node //= 2
        tables.append((t + [-1] * (depth - len(t)))[:depth])
        codes.append((c + [0] * (depth - len(c)))[:depth])
    return np.asarray(tables, np.int64), np.asarray(codes, np.float32)


def hsigmoid_loss(input, label, num_classes: int, weight,  # noqa: A002
                  bias=None, path_table=None, path_code=None,
                  is_sparse: bool = False):
    """Hierarchical sigmoid: -sum over each label's path of log
    sigmoid(+-(x . w_node + b_node)), (B, 1).  The default tree is the
    word2vec heap over ``num_classes`` leaves (weight (C - 1, F)), built
    on the host from the labels; a custom tree comes as ``path_table`` /
    ``path_code`` ((B, L) node rows and branch codes, -1 padded)."""
    x = _f32(input)
    w = _f32(weight)
    if path_table is None:
        lab = label.cpu() if torch.is_tensor(label) else label
        t, c = _heap_paths(np.asarray(lab).reshape(-1), num_classes)
        path_table = torch.from_numpy(t).to(x.device)
        path_code = torch.from_numpy(c).to(x.device, x.dtype)
    else:
        path_table = torch.as_tensor(path_table, device=x.device).long()
        path_code = torch.as_tensor(path_code, device=x.device).to(x.dtype)
    valid = path_table >= 0
    safe = torch.where(valid, path_table, torch.zeros_like(path_table))
    z = torch.einsum("bf,blf->bl", x, w[safe])
    if bias is not None:
        z = z + _f32(bias).reshape(-1)[safe]
    ll = TF.logsigmoid((2.0 * path_code - 1.0) * z)
    return -torch.where(valid, ll, ll.new_zeros(())).sum(dim=1)[:, None]


# ---------------------------------------------------------------------------
# Norms (_functional_ext.py:714-751)
# ---------------------------------------------------------------------------
def local_response_norm(x, size: int = 5, alpha: float = 1e-4,
                        beta: float = 0.75, k: float = 1.0,
                        data_format: str = "NCHW"):
    """x / (k + alpha / size x the sum of squares over a window of
    ``size`` channels)^beta, the window's odd unit after the channel."""
    axis = 1 if data_format.startswith("NC") else x.dim() - 1
    sq = (x * x).movedim(axis, -1)
    lo = (size - 1) // 2
    sq = TF.pad(sq, (lo, size - 1 - lo))
    acc = sq.unfold(-1, size, 1).sum(-1).movedim(-1, axis)
    return x / torch.pow(k + alpha / size * acc, beta)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats: bool = True,
                  momentum: float = 0.9, eps: float = 1e-5,
                  data_format: str = "NCHW"):
    """Each sample's channels normalised over their spatial dims (the
    biased variance); the running statistics are not used or updated, as
    in the JAX op."""
    enforce(data_format.startswith("NC"),
            "instance_norm supports channel-first layouts")
    axes = tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if weight is not None:
        y = y * weight.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Vision (_functional_ext.py:757-817)
# ---------------------------------------------------------------------------
def affine_grid(theta, out_shape, align_corners: bool = True):
    """(N, 2, 3) affine matrices -> (N, H, W, 2) sampling grid in [-1, 1],
    float32 (float64 for float64 matrices)."""
    theta = _f32(theta)
    n, c, h, w = out_shape
    dev = theta.device
    dt = theta.dtype
    if align_corners:
        ys = torch.linspace(-1, 1, h, device=dev, dtype=dt)
        xs = torch.linspace(-1, 1, w, device=dev, dtype=dt)
    else:
        ys = (torch.arange(h, device=dev, dtype=dt) + 0.5) * 2 / h - 1
        xs = (torch.arange(w, device=dev, dtype=dt) + 0.5) * 2 / w - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,njk->nhwj", base, theta)


def grid_sample(x, grid, mode: str = "bilinear",
                padding_mode: str = "zeros", align_corners: bool = True):
    """Sample (N, C, H, W) at (N, Ho, Wo, 2) normalised coordinates by
    gathers: bilinear or nearest (round half to even); zeros (out of
    bounds reads 0) or border padding."""
    grid = _f32(grid)
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx, fy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
    else:
        fx, fy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2
    rows = torch.arange(n, device=x.device)[:, None, None]

    def gather(ix, iy):
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        if padding_mode == "border":
            ixc, iyc = ix.clamp(0, w - 1), iy.clamp(0, h - 1)
        else:
            ixc = torch.where(inside, ix, torch.zeros_like(ix))
            iyc = torch.where(inside, iy, torch.zeros_like(iy))
        vals = x[rows, :, iyc, ixc]
        if padding_mode == "zeros":
            vals = torch.where(inside[..., None], vals, vals.new_zeros(()))
        return vals

    if mode == "nearest":
        out = gather(torch.round(fx).long(), torch.round(fy).long())
    else:
        x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
        dx, dy = (fx - x0)[..., None], (fy - y0)[..., None]
        out = (gather(x0, y0) * (1 - dx) * (1 - dy)
               + gather(x0 + 1, y0) * dx * (1 - dy)
               + gather(x0, y0 + 1) * (1 - dx) * dy
               + gather(x0 + 1, y0 + 1) * dx * dy)
    return out.movedim(-1, 1).to(x.dtype)
