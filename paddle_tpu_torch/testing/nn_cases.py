"""The case table of the functional ops and layers of the port's ``nn``
beyond the vision and Transformer ones: small seeded numpy inputs, the
arguments and which inputs take a gradient.  The CPU parity tests run each
case through the JAX package and the port (``tests/test_torch_nn_*.py``);
``chip_smoke.py`` phase c2i (4) runs each on the card against the CPU's
float64 result.  It needs no JAX.

A functional case is ``Case(name, fn, args, kwargs, grad)``: ``fn`` is the
name of the function in both ``nn.functional``\\ s, ``args`` its
positional arguments (numpy arrays become tensors, the rest is passed as
it is), ``grad`` the positions of the float arrays to differentiate
``sum(out * ct)`` by.  A layer case is ``LayerCase(name, cls, args,
kwargs, inputs, grad, call)``: the class of both ``nn``\\ s, its
constructor's arguments (``device`` added for the port's classes that
take one), the forward's numpy inputs and keyword arguments."""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

__all__ = ["Case", "LayerCase", "functional_cases", "layer_cases",
           "REDUCTIONS"]

REDUCTIONS = ("mean", "sum", "none")


class Case(NamedTuple):
    name: str
    fn: str
    args: Sequence[Any]
    kwargs: Dict[str, Any]
    grad: Tuple[int, ...]


class LayerCase(NamedTuple):
    name: str
    cls: str
    args: Sequence[Any]
    kwargs: Dict[str, Any]
    inputs: Sequence[Any]
    grad: Tuple[int, ...]
    call: Dict[str, Any]


def _n(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype(np.float32)


def _u(seed, lo, hi, *shape):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _i(seed, hi, *shape, lo=0):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(
        np.int64)


def _log_softmax(a, axis=-1):
    a = a - a.max(axis=axis, keepdims=True)
    return (a - np.log(np.exp(a).sum(axis=axis, keepdims=True))).astype(
        np.float32)


def _pool_indices(seed, n, c, h, w, k):
    """Flat indices of one position inside each k x k window of an
    (h, w) plane, as ``max_pool2d(return_mask=True)`` gives them."""
    r = np.random.RandomState(seed)
    oh, ow = h // k, w // k
    dy = r.randint(0, k, (n, c, oh, ow))
    dx = r.randint(0, k, (n, c, oh, ow))
    rows = np.arange(oh)[:, None] * k + dy
    cols = np.arange(ow)[None, :] * k + dx
    return (rows * w + cols).astype(np.int64)


def _csr(seed, b, h, s, per_row):
    """CSR offsets and columns of ``per_row`` (at most) sorted columns a
    row, one empty row, padded to a common nnz."""
    r = np.random.RandomState(seed)
    offs = np.zeros((b, h, s + 1), np.int64)
    cols = []
    for bi in range(b):
        for hi in range(h):
            row_cols = []
            for q in range(s):
                k = 0 if q == 1 else r.randint(1, per_row + 1)
                row_cols.append(np.sort(r.choice(s, k, replace=False)))
                offs[bi, hi, q + 1] = offs[bi, hi, q] + k
            cols.append(np.concatenate(row_cols))
    nnz = max(len(c) for c in cols)
    out = np.zeros((b * h, nnz), np.int64)
    for i, c in enumerate(cols):
        out[i, :len(c)] = c
        # the padding past the last offset belongs to the last row
        out[i, len(c):] = c[-1] if len(c) else 0
    return offs, out.reshape(b, h, nnz)


def _ctc_inputs(seed, T, B, C, labels, label_lengths, input_lengths):
    logits = _n(seed, T, B, C)
    return [_log_softmax(logits), np.asarray(labels, np.int64),
            np.asarray(input_lengths, np.int64),
            np.asarray(label_lengths, np.int64)]


def functional_cases() -> List[Case]:
    x = _n(1, 2, 3, 5)
    img = _n(2, 2, 4, 6, 7)
    out: List[Case] = [
        Case("gelu_erf", "gelu", [x * 3], {}, (0,)),
        Case("gelu_tanh", "gelu", [x * 3], {"approximate": True}, (0,)),
        Case("elu", "elu", [x * 2], {"alpha": 0.7}, (0,)),
        Case("mish", "mish", [x * 3], {}, (0,)),
        Case("softplus", "softplus", [x * 4], {"beta": 2.0,
                                                "threshold": 5.0}, (0,)),
        Case("celu", "celu", [x * 2], {"alpha": 1.5}, (0,)),
        Case("selu", "selu", [x * 2], {}, (0,)),
        Case("softsign", "softsign", [x], {}, (0,)),
        Case("softshrink", "softshrink", [x], {"threshold": 0.3}, (0,)),
        Case("hardshrink", "hardshrink", [x], {"threshold": 0.3}, (0,)),
        Case("hardtanh", "hardtanh", [x * 2], {"min": -0.5, "max": 1.2},
             (0,)),
        Case("tanhshrink", "tanhshrink", [x], {}, (0,)),
        Case("thresholded_relu", "thresholded_relu", [x * 2],
             {"threshold": 0.4}, (0,)),
        Case("log_sigmoid", "log_sigmoid", [x * 3], {}, (0,)),
        Case("maxout", "maxout", [_n(3, 2, 6, 3, 3)], {"groups": 3}, (0,)),
        Case("maxout_last_axis", "maxout", [_n(3, 2, 3, 4)],
             {"groups": 2, "axis": -1}, (0,)),
        Case("glu", "glu", [_n(4, 3, 8)], {"axis": -1}, (0,)),
        Case("prelu_shared", "prelu", [img, np.asarray([0.2], np.float32)],
             {}, (0, 1)),
        Case("prelu_channel", "prelu", [img, _u(5, 0.1, 0.4, 4)], {},
             (0, 1)),
        Case("square_error_cost", "square_error_cost", [x, _n(6, 2, 3, 5)],
             {}, (0, 1)),
        Case("label_smooth", "label_smooth",
             [np.eye(5, dtype=np.float32)[_i(7, 5, 6)]], {"epsilon": 0.2},
             (0,)),
        Case("label_smooth_prior", "label_smooth",
             [np.eye(4, dtype=np.float32)[_i(8, 4, 3)],
              _u(9, 0.1, 1.0, 4)], {"epsilon": 0.1}, (0,)),
        Case("softmax_mask_fuse_upper_triangle",
             "softmax_mask_fuse_upper_triangle", [_n(10, 2, 2, 4, 6)], {},
             (0,)),
        Case("clip", "clip", [x * 2], {"min": -0.5, "max": 0.8}, (0,)),
        Case("normalize_p2", "normalize", [x], {"axis": 1}, (0,)),
        Case("normalize_p1_last", "normalize", [x], {"p": 1.0, "axis": -1},
             (0,)),
        Case("cosine_similarity", "cosine_similarity",
             [_n(11, 4, 6), _n(12, 4, 6)], {"axis": 1}, (0, 1)),
        Case("pairwise_distance", "pairwise_distance",
             [_n(13, 4, 6), _n(14, 4, 6)], {"p": 2.0}, (0, 1)),
        Case("pairwise_distance_p1_keepdim", "pairwise_distance",
             [_n(13, 4, 6), _n(14, 4, 6)], {"p": 1.0, "keepdim": True},
             (0, 1)),
        Case("pixel_shuffle_nchw", "pixel_shuffle", [_n(15, 2, 8, 3, 2)],
             {"upscale_factor": 2}, (0,)),
        Case("pixel_shuffle_nhwc", "pixel_shuffle", [_n(15, 2, 3, 2, 8)],
             {"upscale_factor": 2, "data_format": "NHWC"}, (0,)),
        Case("pixel_unshuffle_nchw", "pixel_unshuffle", [_n(16, 2, 2, 6, 4)],
             {"downscale_factor": 2}, (0,)),
        Case("pixel_unshuffle_nhwc", "pixel_unshuffle", [_n(16, 2, 6, 4, 2)],
             {"downscale_factor": 2, "data_format": "NHWC"}, (0,)),
        Case("diag_embed", "diag_embed", [_n(17, 2, 3)], {}, (0,)),
        Case("diag_embed_offset_dims", "diag_embed", [_n(17, 2, 3)],
             {"offset": -1, "dim1": 0, "dim2": 2}, (0,)),
        Case("sequence_mask", "sequence_mask", [np.asarray([0, 3, 5, 2])],
             {"maxlen": 6}, ()),
        Case("zeropad2d", "zeropad2d", [img], {"padding": [1, 2, 0, 3]},
             (0,)),
        Case("zeropad2d_nhwc", "zeropad2d", [img],
             {"padding": [1, 0, 2, 1], "data_format": "NHWC"}, (0,)),
        Case("bilinear", "bilinear", [_n(18, 3, 4), _n(19, 3, 5),
                                      _n(20, 6, 4, 5), _n(21, 6)], {},
             (0, 1, 2, 3)),
        Case("temporal_shift", "temporal_shift", [_n(22, 6, 8, 2, 2)],
             {"seg_num": 3, "shift_ratio": 0.25}, (0,)),
        Case("local_response_norm", "local_response_norm",
             [_n(23, 2, 7, 3, 3)], {"size": 5, "alpha": 0.1}, (0,)),
        Case("local_response_norm_nhwc_even", "local_response_norm",
             [_n(23, 2, 3, 3, 7)], {"size": 4, "data_format": "NHWC"},
             (0,)),
        Case("instance_norm", "instance_norm",
             [_n(24, 2, 3, 4, 5), None, None, _u(25, 0.5, 1.5, 3),
              _n(26, 3)], {}, (0, 3, 4)),
        Case("affine_grid_align", "affine_grid", [_n(27, 2, 2, 3)],
             {"out_shape": (2, 1, 4, 5)}, (0,)),
        Case("affine_grid_half_pixel", "affine_grid", [_n(27, 2, 2, 3)],
             {"out_shape": (2, 1, 4, 5), "align_corners": False}, (0,)),
    ]
    grid = _u(28, -1.2, 1.2, 2, 3, 4, 2)
    for mode in ("bilinear", "nearest"):
        for padding in ("zeros", "border"):
            for align in (True, False):
                out.append(Case(
                    f"grid_sample_{mode}_{padding}_"
                    f"{'align' if align else 'half'}", "grid_sample",
                    [_n(29, 2, 3, 5, 6), grid],
                    {"mode": mode, "padding_mode": padding,
                     "align_corners": align},
                    (0, 1) if mode == "bilinear" else (0,)))
    out += _pad_cases(img) + _conv_cases() + _pool_cases() + _loss_cases()
    out += _resize_cases() + _ctc_cases() + _sparse_attention_cases()
    out += [
        Case("dropout_p0", "dropout", [x], {"p": 0.0}, (0,)),
        Case("dropout2d_eval", "dropout2d", [img], {"p": 0.5,
                                                    "training": False}, (0,)),
        Case("dropout3d_p0", "dropout3d", [_n(30, 2, 3, 2, 2, 2)],
             {"p": 0.0}, (0,)),
        Case("alpha_dropout_eval", "alpha_dropout", [x],
             {"p": 0.5, "training": False}, (0,)),
    ]
    return out


def _pad_cases(img):
    out = [Case("pad_constant_trailing", "pad", [img],
                {"paddings": [1, 2, 0, 1], "value": 0.5}, (0,)),
           Case("pad_constant_every_dim", "pad", [img],
                {"paddings": [0, 1, 1, 0, 2, 1, 0, 0]}, (0,))]
    for mode in ("reflect", "symmetric", "edge", "wrap"):
        out.append(Case(f"pad_{mode}", "pad", [img],
                        {"paddings": [2, 1, 1, 3], "mode": mode}, (0,)))
    return out


def _conv_cases():
    c = Case
    return [
        c("conv3d", "conv3d", [_n(40, 2, 4, 5, 6, 5), _n(41, 6, 2, 3, 2, 3),
                               _n(42, 6)],
          {"stride": (1, 2, 1), "padding": 1, "dilation": (1, 1, 2),
           "groups": 2}, (0, 1, 2)),
        c("conv3d_same_ndhwc", "conv3d",
          [_n(43, 2, 5, 6, 4, 3), _n(44, 4, 3, 2, 3, 2)],
          {"stride": 2, "padding": "SAME", "data_format": "NDHWC"}, (0, 1)),
        c("conv2d_transpose", "conv2d_transpose",
          [_n(45, 2, 4, 5, 6), _n(46, 4, 3, 3, 3), _n(47, 3)],
          {"stride": 2, "padding": 1, "output_padding": 1}, (0, 1, 2)),
        c("conv2d_transpose_groups_dilation", "conv2d_transpose",
          [_n(48, 2, 6, 4, 5), _n(49, 6, 2, 3, 2), _n(50, 6)],
          {"stride": (2, 1), "padding": (1, 0), "output_padding": (1, 0),
           "dilation": (2, 2), "groups": 3}, (0, 1, 2)),
        c("conv2d_transpose_dilated_output_padding", "conv2d_transpose",
          [_n(51, 1, 2, 4, 4), _n(52, 2, 3, 3, 3)],
          {"stride": 1, "padding": 1, "output_padding": 1, "dilation": 2},
          (0, 1)),
        c("conv2d_transpose_output_padding_past_stride",
          "conv2d_transpose", [_n(53, 1, 2, 3, 4), _n(54, 2, 2, 2, 2)],
          {"stride": 2, "padding": 1, "output_padding": 3}, (0, 1)),
        c("conv2d_transpose_nhwc", "conv2d_transpose",
          [_n(55, 2, 4, 5, 3), _n(56, 3, 2, 3, 3), _n(57, 2)],
          {"stride": 2, "data_format": "NHWC"}, (0, 1, 2)),
        c("conv1d_transpose", "conv1d_transpose",
          [_n(58, 2, 4, 7), _n(59, 4, 3, 3), _n(60, 6)],
          {"stride": 2, "padding": 1, "output_padding": 1, "groups": 2},
          (0, 1, 2)),
        c("conv1d_transpose_nlc_dilation", "conv1d_transpose",
          [_n(61, 2, 7, 3), _n(62, 3, 2, 3)],
          {"stride": 3, "dilation": 2, "data_format": "NLC"}, (0, 1)),
        c("conv3d_transpose", "conv3d_transpose",
          [_n(63, 1, 4, 3, 4, 3), _n(64, 4, 1, 2, 3, 2), _n(65, 2)],
          {"stride": (2, 1, 2), "padding": (0, 1, 0),
           "output_padding": (1, 0, 1), "groups": 2}, (0, 1, 2)),
        c("conv3d_transpose_ndhwc", "conv3d_transpose",
          [_n(66, 1, 3, 4, 3, 2), _n(67, 2, 3, 2, 2, 2)],
          {"stride": 2, "data_format": "NDHWC"}, (0, 1)),
    ]


def _pool_cases():
    c = Case
    x1 = _n(70, 2, 3, 11)
    x3 = _n(71, 2, 3, 5, 6, 7)
    return [
        c("max_pool1d", "max_pool1d", [x1], {"kernel_size": 3, "stride": 2,
                                             "padding": 1}, (0,)),
        c("avg_pool1d", "avg_pool1d", [x1], {"kernel_size": 3, "stride": 2,
                                             "padding": 1}, (0,)),
        c("max_pool3d", "max_pool3d", [x3], {"kernel_size": 2, "stride": 2,
                                             "padding": 1}, (0,)),
        c("max_pool3d_ndhwc", "max_pool3d", [_n(72, 2, 5, 6, 7, 3)],
          {"kernel_size": (2, 3, 2), "data_format": "NDHWC"}, (0,)),
        c("avg_pool3d", "avg_pool3d", [x3], {"kernel_size": 3, "stride": 2,
                                             "padding": 1}, (0,)),
        c("avg_pool3d_wide_padding", "avg_pool3d", [x3],
          {"kernel_size": 2, "stride": 2, "padding": (1, 0, 1)}, (0,)),
        c("adaptive_avg_pool1d", "adaptive_avg_pool1d", [x1],
          {"output_size": 4}, (0,)),
        c("adaptive_max_pool1d", "adaptive_max_pool1d", [x1],
          {"output_size": 4}, (0,)),
        c("adaptive_avg_pool3d", "adaptive_avg_pool3d", [x3],
          {"output_size": (2, 4, 3)}, (0,)),
        c("adaptive_max_pool3d", "adaptive_max_pool3d", [x3],
          {"output_size": (3, 4, 2)}, (0,)),
        c("max_pool2d_return_mask", "max_pool2d", [_n(73, 2, 3, 6, 8)],
          {"kernel_size": 2, "return_mask": True}, (0,)),
        c("max_unpool1d", "max_unpool1d",
          [_n(74, 2, 3, 4), np.arange(4) * 2 + _i(75, 2, 2, 3, 4)],
          {"kernel_size": 2}, (0,)),
        c("max_unpool2d", "max_unpool2d",
          [_n(76, 2, 3, 3, 4), _pool_indices(77, 2, 3, 6, 8, 2)],
          {"kernel_size": 2}, (0,)),
        c("max_unpool2d_output_size", "max_unpool2d",
          [_n(76, 2, 3, 3, 4), _pool_indices(77, 2, 3, 6, 8, 2)],
          {"kernel_size": 2, "output_size": (7, 9)}, (0,)),
        c("max_unpool3d", "max_unpool3d",
          [_n(78, 1, 2, 2, 2, 2), np.arange(8).reshape(1, 1, 2, 2, 2)
           .repeat(2, 1) * 7 % 64], {"kernel_size": 2}, (0,)),
        c("unfold", "unfold", [_n(79, 2, 3, 6, 7)],
          {"kernel_sizes": [2, 3], "strides": [1, 2], "paddings": 1,
           "dilations": [2, 1]}, (0,)),
        c("fold", "fold", [_n(80, 2, 12, 15)],
          {"output_sizes": [4, 5], "kernel_sizes": 2, "paddings": 1,
           "strides": [1, 2]}, (0,)),
    ]


def _loss_cases():
    out = []
    a, b = _n(90, 4, 5), _n(91, 4, 5)
    probs = _u(92, 0.05, 0.95, 4, 5)
    logp = _log_softmax(_n(93, 4, 5))
    sign = np.where(_n(94, 4) > 0, 1.0, -1.0).astype(np.float32)
    for red in REDUCTIONS:
        out += [
            Case(f"l1_loss_{red}", "l1_loss", [a, b], {"reduction": red},
                 (0, 1)),
            Case(f"mse_loss_{red}", "mse_loss", [a, b], {"reduction": red},
                 (0, 1)),
            Case(f"bce_with_logits_{red}",
                 "binary_cross_entropy_with_logits",
                 [a * 3, probs], {"reduction": red}, (0, 1)),
            Case(f"smooth_l1_loss_{red}", "smooth_l1_loss", [a, b],
                 {"reduction": red, "delta": 0.7}, (0, 1)),
            Case(f"kl_div_{red}", "kl_div",
                 [logp, np.where(probs > 0.3, probs, 0).astype(np.float32)],
                 {"reduction": red}, (0, 1)),
            Case(f"margin_ranking_loss_{red}", "margin_ranking_loss",
                 [a[:, 0], b[:, 0], sign], {"margin": 0.2,
                                            "reduction": red}, (0, 1)),
            Case(f"hinge_embedding_loss_{red}", "hinge_embedding_loss",
                 [a, np.where(b > 0, 1.0, -1.0).astype(np.float32)],
                 {"margin": 0.8, "reduction": red}, (0,)),
            Case(f"cosine_embedding_loss_{red}", "cosine_embedding_loss",
                 [a, b, sign.astype(np.int64)],
                 {"margin": 0.1, "reduction": red}, (0, 1)),
            Case(f"triplet_margin_loss_{red}", "triplet_margin_loss",
                 [a, b, _n(95, 4, 5)], {"reduction": red}, (0, 1, 2)),
            Case(f"binary_cross_entropy_{red}", "binary_cross_entropy",
                 [probs, (_n(96, 4, 5) > 0).astype(np.float32)],
                 {"reduction": red}, (0,)),
            Case(f"sigmoid_focal_loss_{red}", "sigmoid_focal_loss",
                 [a * 2, (b > 0).astype(np.float32)], {"reduction": red},
                 (0,)),
            Case(f"margin_cross_entropy_{red}", "margin_cross_entropy",
                 [_u(97, -0.9, 0.9, 4, 6), _i(98, 6, 4)],
                 {"reduction": red, "scale": 8.0}, (0,)),
        ]
    out += [
        Case("triplet_margin_loss_swap_p1", "triplet_margin_loss",
             [a, b, _n(95, 4, 5)], {"swap": True, "p": 1.0, "margin": 2.0},
             (0, 1, 2)),
        Case("binary_cross_entropy_weight", "binary_cross_entropy",
             [probs, (_n(96, 4, 5) > 0).astype(np.float32),
              _u(99, 0.5, 2.0, 5)], {}, (0,)),
        Case("sigmoid_focal_loss_normalizer", "sigmoid_focal_loss",
             [a * 2, (b > 0).astype(np.float32), np.float32(3.0)],
             {"alpha": 0.4, "gamma": 1.5}, (0,)),
        Case("dice_loss", "dice_loss",
             [np.exp(_log_softmax(_n(100, 3, 4, 5))), _i(101, 5, 3, 4, 1)],
             {}, (0,)),
        Case("log_loss", "log_loss",
             [_u(102, 0.05, 0.95, 6, 1), (_n(103, 6, 1) > 0).astype(
                 np.float32)], {}, (0,)),
        Case("npair_loss", "npair_loss",
             [_n(104, 5, 6), _n(105, 5, 6), np.asarray([0, 1, 0, 2, 1])],
             {}, (0, 1)),
        Case("softmax_with_cross_entropy_hard", "softmax_with_cross_entropy",
             [_n(106, 5, 6), np.asarray([[1], [5], [-100], [0], [3]])],
             {}, (0,)),
        Case("softmax_with_cross_entropy_soft", "softmax_with_cross_entropy",
             [_n(107, 5, 6), np.exp(_log_softmax(_n(108, 5, 6)))],
             {"soft_label": True}, (0, 1)),
        Case("softmax_with_cross_entropy_return_softmax",
             "softmax_with_cross_entropy",
             [_n(109, 5, 6), np.asarray([1, 5, 2, 0, 3])],
             {"return_softmax": True}, (0,)),
        Case("margin_cross_entropy_return_softmax", "margin_cross_entropy",
             [_u(110, -0.9, 0.9, 4, 6), _i(111, 6, 4)],
             {"return_softmax": True, "margin2": 0.3, "margin3": 0.1},
             (0,)),
        Case("hsigmoid_loss_default_tree", "hsigmoid_loss",
             [_n(112, 6, 4), _i(113, 7, 6), 7, _n(114, 6, 4),
              _n(115, 6)], {}, (0, 3, 4)),
        Case("hsigmoid_loss_custom_paths", "hsigmoid_loss",
             [_n(116, 3, 4), _i(117, 5, 3), 5, _n(118, 4, 4), None],
             {"path_table": np.asarray([[0, 1, -1], [0, 2, 3], [1, -1, -1]]),
              "path_code": np.asarray([[1, 0, 0], [0, 1, 1], [1, 0, 0]])},
             (0, 3)),
    ]
    return out


def _resize_cases():
    """``interpolate`` / ``upsample``: nearest and bilinear, shrinking and
    growing, ``align_corners`` both ways, NCHW and NHWC."""
    out = []
    x = _n(120, 1, 2, 9, 13)
    for size in ((4, 6), (7, 5), (18, 26)):
        tag = "x".join(map(str, size))
        out.append(Case(f"interpolate_nearest_{tag}", "interpolate", [x],
                        {"size": size}, (0,)))
        out.append(Case(f"interpolate_bilinear_{tag}", "interpolate", [x],
                        {"size": size, "mode": "bilinear"}, (0,)))
        out.append(Case(f"interpolate_bilinear_align_{tag}", "interpolate",
                        [x], {"size": size, "mode": "bilinear",
                              "align_corners": True}, (0,)))
    xh = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    out += [
        Case("interpolate_bilinear_nhwc_shrink", "interpolate", [xh],
             {"size": (5, 6), "mode": "bilinear", "data_format": "NHWC"},
             (0,)),
        Case("interpolate_nearest_nhwc_scale", "interpolate", [xh],
             {"scale_factor": 1.5, "data_format": "NHWC"}, (0,)),
        Case("upsample_bilinear_scale", "upsample", [x],
             {"scale_factor": 0.5, "mode": "bilinear"}, (0,)),
        Case("upsample_bilinear_align_nhwc", "upsample", [xh],
             {"size": (12, 20), "mode": "bilinear", "align_corners": True,
              "data_format": "NHWC"}, (0,)),
    ]
    return out


def _ctc_cases():
    """Repeated labels, a zero-length label, input lengths below T, every
    reduction; the gradient is taken with respect to ``log_probs``."""
    out = []
    labels = [[1, 1, 2, 3], [2, 4, 4, 0], [0, 0, 0, 0], [3, 2, 1, 1]]
    args = _ctc_inputs(130, 12, 4, 6, labels, [4, 3, 0, 2], [12, 9, 5, 12])
    for red in REDUCTIONS:
        out.append(Case(f"ctc_loss_{red}", "ctc_loss", args,
                        {"reduction": red}, (0,)))
    out.append(Case("ctc_loss_blank_last", "ctc_loss",
                    _ctc_inputs(131, 10, 2, 5, [[0, 1, 1], [2, 3, 0]],
                                [3, 2], [10, 7]), {"blank": 4}, (0,)))
    return out


def _sparse_attention_cases():
    b, h, s, d = 2, 2, 6, 4
    offs, cols = _csr(140, b, h, s, 3)
    q, k, v = _n(141, b, h, s, d), _n(142, b, h, s, d), _n(143, b, h, s, d)
    kpm = np.where(_n(144, b, s) > 1.2, -1e4, 0.0).astype(np.float32)
    am = (_n(145, s, s) * 0.5).astype(np.float32)
    return [
        Case("sparse_attention", "sparse_attention", [q, k, v, offs, cols],
             {}, (0, 1, 2)),
        Case("sparse_attention_masks", "sparse_attention",
             [q, k, v, offs, cols, kpm, am], {}, (0, 1, 2)),
    ]


def layer_cases() -> List[LayerCase]:
    """Every new layer of ``nn`` with parameters or arguments of its own;
    the activation and loss wrappers each once."""
    L = LayerCase
    img = _n(200, 2, 4, 6, 5)
    x = _n(201, 3, 6)
    vol = _n(202, 2, 3, 4, 5, 4)
    seq = _n(203, 2, 4, 9)
    out = [
        L("GroupNorm", "GroupNorm", [2, 4], {}, [img], (0,), {}),
        L("Conv1D", "Conv1D", [4, 6, 3], {"stride": 2, "padding": 1,
                                          "groups": 2}, [seq], (0,), {}),
        L("Conv3D", "Conv3D", [3, 4, (2, 3, 2)], {"padding": 1}, [vol],
          (0,), {}),
        L("Conv2DTranspose", "Conv2DTranspose", [4, 6, 3],
          {"stride": 2, "padding": 1, "groups": 2}, [img], (0,), {}),
        L("Conv2DTranspose_output_size", "Conv2DTranspose", [4, 3, 3],
          {"stride": 2, "padding": 1}, [img], (0,),
          {"output_size": (12, 10)}),
        L("Conv2DTranspose_no_bias_nhwc", "Conv2DTranspose", [5, 2, 2],
          {"stride": 2, "bias_attr": False, "data_format": "NHWC"},
          [_n(204, 2, 3, 4, 5)], (0,), {}),
        L("Conv1DTranspose", "Conv1DTranspose", [4, 2, 3],
          {"stride": 2, "output_padding": 1}, [seq], (0,), {}),
        L("Conv3DTranspose", "Conv3DTranspose", [3, 4, 2],
          {"stride": 2, "padding": 1}, [vol], (0,), {}),
        L("MaxPool1D", "MaxPool1D", [3, 2, 1], {}, [seq], (0,), {}),
        L("AvgPool1D", "AvgPool1D", [2], {}, [seq], (0,), {}),
        L("InstanceNorm1D", "InstanceNorm1D", [4], {}, [seq], (0,), {}),
        L("InstanceNorm2D", "InstanceNorm2D", [4], {}, [img], (0,), {}),
        L("InstanceNorm3D_no_affine", "InstanceNorm3D", [3],
          {"weight_attr": False, "bias_attr": False}, [vol], (0,), {}),
        L("PReLU", "PReLU", [4], {}, [img], (0,), {}),
        L("Unflatten", "Unflatten", [1, (2, 2)], {}, [img], (0,), {}),
        L("Upsample", "Upsample", [], {"size": (3, 8), "mode": "bilinear"},
          [img], (0,), {}),
        L("UpsamplingBilinear2D", "UpsamplingBilinear2D", [],
          {"scale_factor": 2}, [img], (0,), {}),
        L("UpsamplingNearest2D", "UpsamplingNearest2D", [], {"size": (4, 3)},
          [img], (0,), {}),
        L("PixelShuffle", "PixelShuffle", [2], {}, [img], (0,), {}),
        L("PixelUnshuffle", "PixelUnshuffle", [2], {},
          [_n(205, 2, 3, 4, 6)], (0,), {}),
        L("CosineSimilarity", "CosineSimilarity", [], {"axis": -1},
          [x, _n(206, 3, 6)], (0, 1), {}),
        L("PairwiseDistance", "PairwiseDistance", [], {},
          [x, _n(206, 3, 6)], (0, 1), {}),
        L("GLU", "GLU", [], {"axis": 1}, [img], (0,), {}),
        L("Mish", "Mish", [], {}, [x], (0,), {}),
        L("Softplus", "Softplus", [], {}, [x * 10], (0,), {}),
        L("MSELoss", "MSELoss", [], {"reduction": "sum"},
          [x, _n(207, 3, 6)], (0, 1), {}),
        L("L1Loss", "L1Loss", [], {}, [x, _n(207, 3, 6)], (0, 1), {}),
        L("NLLLoss", "NLLLoss", [], {}, [_log_softmax(x), _i(208, 6, 3)],
          (0,), {}),
        L("BCEWithLogitsLoss", "BCEWithLogitsLoss", [], {"reduction": "none"},
          [x, _u(209, 0, 1, 3, 6)], (0, 1), {}),
        L("SmoothL1Loss", "SmoothL1Loss", [], {"delta": 0.5},
          [x, _n(207, 3, 6)], (0, 1), {}),
        L("KLDivLoss", "KLDivLoss", [], {"reduction": "sum"},
          [_log_softmax(x), np.exp(_log_softmax(_n(210, 3, 6)))], (0, 1),
          {}),
        L("MarginRankingLoss", "MarginRankingLoss", [], {"margin": 0.1},
          [x[:, 0], x[:, 1], np.asarray([1.0, -1.0, 1.0], np.float32)],
          (0, 1), {}),
        L("HingeEmbeddingLoss", "HingeEmbeddingLoss", [], {},
          [x, np.where(_n(211, 3, 6) > 0, 1.0, -1.0).astype(np.float32)],
          (0,), {}),
        L("CosineEmbeddingLoss", "CosineEmbeddingLoss", [], {"margin": 0.2},
          [x, _n(206, 3, 6), np.asarray([1, -1, 1])], (0, 1), {}),
        L("TripletMarginLoss", "TripletMarginLoss", [], {"swap": True},
          [x, _n(206, 3, 6), _n(212, 3, 6)], (0, 1, 2), {}),
        L("CTCLoss", "CTCLoss", [], {"reduction": "sum"},
          _ctc_inputs(213, 8, 2, 5, [[1, 2, 2], [3, 0, 0]], [3, 1], [8, 6]),
          (0,), {}),
        L("CELU", "CELU", [0.8], {}, [x], (0,), {}),
        L("ELU", "ELU", [], {"alpha": 0.5}, [x], (0,), {}),
        L("SELU", "SELU", [], {}, [x], (0,), {}),
        L("Silu", "Silu", [], {}, [x], (0,), {}),
        L("Swish", "Swish", [], {}, [x], (0,), {}),
        L("Softsign", "Softsign", [], {}, [x], (0,), {}),
        L("LogSigmoid", "LogSigmoid", [], {}, [x], (0,), {}),
        L("Hardshrink", "Hardshrink", [0.2], {}, [x], (0,), {}),
        L("Softshrink", "Softshrink", [], {"threshold": 0.2}, [x], (0,), {}),
        L("Tanhshrink", "Tanhshrink", [], {}, [x], (0,), {}),
        L("ThresholdedReLU", "ThresholdedReLU", [0.3], {}, [x], (0,), {}),
        L("Hardtanh", "Hardtanh", [-0.4, 0.6], {}, [x], (0,), {}),
        L("Maxout", "Maxout", [2], {}, [img], (0,), {}),
        L("Pad1D_reflect", "Pad1D", [[2, 1]], {"mode": "reflect"}, [seq],
          (0,), {}),
        L("Pad2D", "Pad2D", [1], {"value": 0.3}, [img], (0,), {}),
        L("Pad3D_edge", "Pad3D", [[1, 0, 0, 2, 1, 1]], {"mode": "edge"},
          [vol], (0,), {}),
        L("ZeroPad2D", "ZeroPad2D", [[1, 0, 2, 1]], {}, [img], (0,), {}),
        L("Unfold", "Unfold", [2], {"strides": 2}, [img], (0,), {}),
        L("Fold", "Fold", [[4, 5], 2], {"paddings": 1}, [_n(214, 2, 8, 30)],
          (0,), {}),
        L("Bilinear", "Bilinear", [6, 5, 4], {}, [x, _n(215, 3, 5)],
          (0, 1), {}),
        L("MaxPool3D", "MaxPool3D", [2], {"stride": 1}, [vol], (0,), {}),
        L("AvgPool3D", "AvgPool3D", [2], {"padding": 1}, [vol], (0,), {}),
        L("AdaptiveAvgPool1D", "AdaptiveAvgPool1D", [4], {}, [seq], (0,),
          {}),
        L("AdaptiveMaxPool1D", "AdaptiveMaxPool1D", [4], {}, [seq], (0,),
          {}),
        L("AdaptiveAvgPool3D", "AdaptiveAvgPool3D", [(2, 3, 3)], {}, [vol],
          (0,), {}),
        L("AdaptiveMaxPool3D", "AdaptiveMaxPool3D", [(3, 2, 3)], {}, [vol],
          (0,), {}),
        L("MaxUnPool2D", "MaxUnPool2D", [2], {},
          [_n(216, 2, 3, 3, 4), _pool_indices(217, 2, 3, 6, 8, 2)], (0,),
          {}),
        L("BatchNorm_act", "BatchNorm", [4], {"act": "relu"}, [img], (0,),
          {}),
        L("SyncBatchNorm", "SyncBatchNorm", [4], {}, [img], (0,), {}),
        L("LocalResponseNorm", "LocalResponseNorm", [3], {}, [img], (0,),
          {}),
        L("BCELoss", "BCELoss", [], {}, [_u(218, 0.05, 0.95, 3, 6),
                                         _u(219, 0, 1, 3, 6)], (0, 1), {}),
        L("HSigmoidLoss", "HSigmoidLoss", [6, 5], {},
          [x, _i(220, 5, 3)], (0,), {}),
    ]
    return out
