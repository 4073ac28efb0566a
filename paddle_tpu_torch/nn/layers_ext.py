"""The long tail of the layers: the port of ``paddle_tpu/nn/layers_ext.py``
(the activation layers, padding, the channel dropouts, ``Unfold`` /
``Fold``, ``Bilinear``, the 3-D and adaptive 1-D / 3-D pools and the
unpools, ``Conv1DTranspose`` / ``Conv3DTranspose``, ``BatchNorm`` /
``SyncBatchNorm``, ``LocalResponseNorm``, ``BCELoss``, ``HSigmoidLoss``,
``LayerDict``) and of its beam-search decoding (``BeamSearchDecoder`` and
``dynamic_decode`` of ``layers_ext.py:492-582``, reference
``nn/decode.py``).  Parameter names and shapes are the JAX ones;
constructors that make a parameter run on ``cuda`` unless
``device="cpu"``.

The beam search's cell contract is paddle's: ``cell(inputs, states) ->
(out, new_states)``, with ``states`` a tree (dicts, lists, tuples) of
tensors whose first dim is batch * beam; ``output_fn`` maps the cell's
output to vocabulary logits.  Ties between equal totals are broken as
``torch.topk`` breaks them."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..framework.errors import enforce
from ..utils.tree import tree_map
from . import functional as F
from . import initializer as I
from .layer import Layer
from .layers import _BatchNormBase
from .rnn import RNNCellBase  # noqa: F401  (re-export, as the JAX module)

__all__ = [
    "CELU", "ELU", "SELU", "Silu", "Swish", "Softsign", "LogSigmoid",
    "Maxout", "Hardshrink", "Softshrink", "Hardtanh", "ThresholdedReLU",
    "Tanhshrink",
    "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D",
    "Dropout2D", "Dropout3D", "AlphaDropout",
    "Unfold", "Fold", "Bilinear",
    "MaxPool3D", "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool3D",
    "AdaptiveMaxPool1D", "AdaptiveMaxPool3D",
    "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
    "Conv1DTranspose", "Conv3DTranspose",
    "BatchNorm", "SyncBatchNorm", "LocalResponseNorm",
    "BCELoss", "HSigmoidLoss",
    "LayerDict", "RNNCellBase", "BeamSearchDecoder", "dynamic_decode",
]


def _act(name, fn, extra=()):
    """A stateless activation layer around ``fn(x, *extra)``: its
    arguments by position or keyword, with the JAX defaults."""
    keys = [k for k, _ in extra]

    def __init__(self, *args, **kwargs):
        Layer.__init__(self)
        params = dict(extra)
        if len(args) > len(keys):
            raise TypeError(f"{name}() takes at most {len(keys)} positional "
                            f"arguments ({len(args)} given)")
        for i, a in enumerate(args):
            params[keys[i]] = a
        for k, v in kwargs.items():
            if k in params:
                params[k] = v
            elif k != "name":
                raise TypeError(f"{name}() got an unexpected keyword "
                                f"argument {k!r}")
        self._extra = [params[k] for k in keys]

    def forward(self, x):
        return fn(x, *self._extra)

    return type(name, (Layer,), {
        "__init__": __init__, "forward": forward, "__module__": __name__,
        "__doc__": f"Stateless {name} activation."})


CELU = _act("CELU", F.celu, (("alpha", 1.0),))
ELU = _act("ELU", F.elu, (("alpha", 1.0),))
SELU = _act("SELU", F.selu, (("scale", 1.0507009873554805),
                             ("alpha", 1.6732632423543772)))
Silu = _act("Silu", F.silu)
Swish = _act("Swish", F.swish)
Softsign = _act("Softsign", F.softsign)
LogSigmoid = _act("LogSigmoid", F.log_sigmoid)
Hardshrink = _act("Hardshrink", F.hardshrink, (("threshold", 0.5),))
Softshrink = _act("Softshrink", F.softshrink, (("threshold", 0.5),))
Tanhshrink = _act("Tanhshrink", F.tanhshrink)
ThresholdedReLU = _act("ThresholdedReLU", F.thresholded_relu,
                       (("threshold", 1.0),))


class Hardtanh(Layer):
    def __init__(self, min: float = -1.0, max: float = 1.0):  # noqa: A002
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return F.hardtanh(x, self.min, self.max)


class Maxout(Layer):
    def __init__(self, groups: int, axis: int = 1):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


# ---------------------------------------------------------------------------
# Padding: a flat [before, after] list per trailing spatial dim, through
# F.pad's convention
# ---------------------------------------------------------------------------
class _PadND(Layer):
    SPATIAL = 1

    def __init__(self, padding, mode: str = "constant", value: float = 0.0,
                 data_format: Optional[str] = None):
        super().__init__()
        if isinstance(padding, int):
            padding = [padding] * (2 * self.SPATIAL)
        enforce(len(padding) == 2 * self.SPATIAL,
                f"padding must have {2 * self.SPATIAL} entries")
        self.padding, self.mode, self.value = list(padding), mode, value

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value)


class Pad1D(_PadND):
    SPATIAL = 1


class Pad2D(_PadND):
    SPATIAL = 2


class Pad3D(_PadND):
    SPATIAL = 3


class ZeroPad2D(Layer):
    def __init__(self, padding, data_format: str = "NCHW"):
        super().__init__()
        self.padding = [padding] * 4 if isinstance(padding, int) else padding
        self.data_format = data_format

    def forward(self, x):
        return F.zeropad2d(x, self.padding, self.data_format)


# ---------------------------------------------------------------------------
# Dropout variants: masks from the device's explicit generator
# ---------------------------------------------------------------------------
class Dropout2D(Layer):
    def __init__(self, p: float = 0.5, data_format: str = "NCHW"):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p: float = 0.5, data_format: str = "NCDHW"):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


# ---------------------------------------------------------------------------
# Shape ops and the bilinear layer
# ---------------------------------------------------------------------------
class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1):
        super().__init__()
        self.args = (output_sizes, kernel_sizes, strides, paddings,
                     dilations)

    def forward(self, x):
        return F.fold(x, *self.args)


class Bilinear(Layer):
    """``weight`` (out, in1, in2) ``XavierUniform`` (the conv fans of that
    shape), ``bias`` (out,) zeros."""

    def __init__(self, in1_features: int, in2_features: int,
                 out_features: int, weight_attr=None, bias_attr=None,
                 device: Optional[torch.device] = None):
        super().__init__()
        dev = resolve_device(device)
        self.weight = I.create_parameter(
            (out_features, in1_features, in2_features),
            default_initializer=I.XavierUniform(), attr=weight_attr,
            device=dev)
        self.bias = (None if bias_attr is False else I.create_parameter(
            (out_features,), is_bias=True, attr=bias_attr, device=dev))

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


# ---------------------------------------------------------------------------
# Pooling layers
# ---------------------------------------------------------------------------
class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format: str = "NCDHW"):
        super().__init__()
        self.args = (kernel_size, stride, padding)
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool3d(x, *self.args, data_format=self.data_format)


class AvgPool3D(MaxPool3D):
    def forward(self, x):
        return F.avg_pool3d(x, *self.args, data_format=self.data_format)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask: bool = False):
        super().__init__()
        enforce(not return_mask,
                "return_mask is unsupported on adaptive max pools here")
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format: str = "NCDHW"):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size, self.data_format)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask: bool = False,
                 data_format: str = "NCDHW"):
        super().__init__()
        enforce(not return_mask,
                "return_mask is unsupported on adaptive max pools here")
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, self.data_format)


class _MaxUnPoolND(Layer):
    FN = None

    def __init__(self, kernel_size, stride=None, padding=0,
                 output_size=None, data_format=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, output_size)

    def forward(self, x, indices):
        return type(self).FN(x, indices, *self.args)


class MaxUnPool1D(_MaxUnPoolND):
    FN = staticmethod(F.max_unpool1d)


class MaxUnPool2D(_MaxUnPoolND):
    FN = staticmethod(F.max_unpool2d)


class MaxUnPool3D(_MaxUnPoolND):
    FN = staticmethod(F.max_unpool3d)


# ---------------------------------------------------------------------------
# Transposed convolutions of 1 and 3 spatial dims
# ---------------------------------------------------------------------------
class _ConvTransposeND(Layer):
    """Weight (in, out / groups, *k) ``XavierUniform``, bias zeros."""

    ND = 1

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, output_padding=0, groups: int = 1,
                 dilation=1, weight_attr=None, bias_attr=None,
                 data_format=None, device: Optional[torch.device] = None):
        super().__init__()
        dev = resolve_device(device)
        k = F._ntuple(kernel_size, self.ND)
        self.weight = I.create_parameter(
            (in_channels, out_channels // groups, *k),
            default_initializer=I.XavierUniform(), attr=weight_attr,
            device=dev)
        self.bias = (None if bias_attr is False else I.create_parameter(
            (out_channels,), is_bias=True, attr=bias_attr, device=dev))
        self.data_format = data_format or ("NCL" if self.ND == 1
                                           else "NCDHW")
        self.conv_args = (stride, padding, output_padding, groups, dilation)

    def forward(self, x):
        s, p, op, g, d = self.conv_args
        fn = F.conv1d_transpose if self.ND == 1 else F.conv3d_transpose
        return fn(x, self.weight, self.bias, stride=s, padding=p,
                  output_padding=op, groups=g, dilation=d,
                  data_format=self.data_format)


class Conv1DTranspose(_ConvTransposeND):
    ND = 1


class Conv3DTranspose(_ConvTransposeND):
    ND = 3


# ---------------------------------------------------------------------------
# Norm layers
# ---------------------------------------------------------------------------
class BatchNorm(_BatchNormBase):
    """The legacy ``paddle.nn.BatchNorm`` signature (``num_channels``
    first, ``param_attr``, ``data_layout``) with an optional ``act``, a
    name of ``nn.functional``."""

    def __init__(self, num_channels: int, act=None, momentum: float = 0.9,
                 epsilon: float = 1e-5, param_attr=None, bias_attr=None,
                 dtype="float32", data_layout="NCHW", in_place=False,
                 moving_mean_name=None, moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False,
                 device: Optional[torch.device] = None):
        super().__init__(num_channels, momentum=momentum, epsilon=epsilon,
                         weight_attr=param_attr, bias_attr=bias_attr,
                         data_format=data_layout,
                         device=resolve_device(device))
        enforce(act is None or callable(getattr(F, act, None)),
                f"BatchNorm: unknown act {act!r}")
        self._act = act

    def forward(self, x):
        y = super().forward(x)
        return y if self._act is None else getattr(F, self._act)(y)


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose statistics would be reduced across data-parallel
    processes; on one card it is the plain batch norm (the cross-process
    form waits for the port's multi-card data parallelism).
    ``convert_sync_batchnorm`` turns every batch norm of a module tree
    into one, keeping its parameters and buffers."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format="NCHW", device: Optional[torch.device] = None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, resolve_device(device))

    @classmethod
    def convert_sync_batchnorm(cls, layer: nn.Module) -> nn.Module:
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            out = cls.__new__(cls)
            out.__dict__.update(layer.__dict__)
            return out
        for name, sub in list(layer._modules.items()):
            if sub is not None:
                layer._modules[name] = cls.convert_sync_batchnorm(sub)
        return layer


class LocalResponseNorm(Layer):
    def __init__(self, size: int = 5, alpha: float = 1e-4,
                 beta: float = 0.75, k: float = 1.0,
                 data_format: str = "NCHW"):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
class BCELoss(Layer):
    def __init__(self, weight=None, reduction: str = "mean"):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):  # noqa: A002
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class HSigmoidLoss(Layer):
    """``weight`` (num_classes - 1, feature_size) ``XavierUniform`` and
    ``bias`` (num_classes - 1,) zeros: one row a node of the tree."""

    def __init__(self, feature_size: int, num_classes: int,
                 weight_attr=None, bias_attr=None, is_custom: bool = False,
                 is_sparse: bool = False,
                 device: Optional[torch.device] = None):
        super().__init__()
        enforce(num_classes >= 2, "num_classes must be >= 2")
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.weight = I.create_parameter(
            (num_classes - 1, feature_size),
            default_initializer=I.XavierUniform(), attr=weight_attr,
            device=dev)
        self.bias = (None if bias_attr is False else I.create_parameter(
            (num_classes - 1,), is_bias=True, attr=bias_attr, device=dev))

    def forward(self, input, label, path_table=None,  # noqa: A002
                path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table, path_code)


# ---------------------------------------------------------------------------
# Containers
# ---------------------------------------------------------------------------
class LayerDict(nn.ModuleDict, Layer):
    """The ordered dict container of sublayers: ``nn.ModuleDict`` as a
    ``Layer``, whose
    state-dict keys (``<key>.<param>``) are the JAX ``LayerDict``'s."""


# ---------------------------------------------------------------------------
# Beam-search decoding (layers_ext.py:492-582)
# ---------------------------------------------------------------------------
def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


class BeamSearchDecoder:
    """Beam search over a cell: each step extends every live beam by every
    token, keeps the ``beam_size`` best totals of each batch row, and
    reorders the cell's states by the parent beams.  A finished beam
    extends only by ``end_token``, at no cost."""

    def __init__(self, cell, start_token: int, end_token: int,
                 beam_size: int, embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token, self.end_token = start_token, end_token
        self.beam_size = beam_size
        self.embedding_fn, self.output_fn = embedding_fn, output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size: int):
        """(B, ...) -> (B * beam, ...), each row repeated ``beam_size``
        times."""
        return torch.repeat_interleave(torch.as_tensor(x), beam_size, dim=0)

    def initialize(self, initial_states, batch_size: int):
        """``(tokens, log_probs, finished, states)``: every beam starts at
        ``start_token``; beam 0 is live (log-prob 0) and the others at
        -1e9, so the first step expands one beam."""
        k = self.beam_size
        states = tree_map(lambda s: self.tile_beam_merge_with_batch(s, k),
                          initial_states)
        leaves = _leaves(states)
        dev = leaves[0].device if leaves else torch.device("cpu")
        tokens = torch.full((batch_size, k), self.start_token,
                            dtype=torch.int32, device=dev)
        log_probs = torch.tensor([0.0] + [-1e9] * (k - 1),
                                 dtype=torch.float32,
                                 device=dev)[None, :].repeat(batch_size, 1)
        finished = torch.zeros((batch_size, k), dtype=torch.bool, device=dev)
        return tokens, log_probs, finished, states

    def step(self, tokens, log_probs, finished, states):
        """One expansion: ``(tokens, log_probs, finished, states, parent)``
        of the kept beams, each (B, beam)."""
        b, k = tokens.shape
        inp = tokens.reshape(b * k)
        if self.embedding_fn is not None:
            inp = self.embedding_fn(inp)
        out, new_states = self.cell(inp, states)
        logits = self.output_fn(out) if self.output_fn is not None else out
        v = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, v)
        fin_mask = torch.full((v,), -1e9, device=logp.device)
        fin_mask[self.end_token] = 0.0
        logp = torch.where(finished[..., None], fin_mask, logp)
        total = log_probs[..., None] + logp
        top_val, top_idx = torch.topk(total.reshape(b, k * v), k, dim=-1)
        parent = (top_idx // v).to(torch.int32)
        token = (top_idx % v).to(torch.int32)

        def reorder(s):
            s = s.reshape(b, k, *s.shape[1:])
            idx = parent.long().reshape(b, k, *([1] * (s.dim() - 2)))
            s = s.gather(1, idx.expand(b, k, *s.shape[2:]))
            return s.reshape(b * k, *s.shape[2:])

        new_states = tree_map(reorder, new_states)
        new_fin = (finished.gather(1, parent.long())
                   | (token == self.end_token))
        return token, top_val, new_fin, new_states, parent


def dynamic_decode(decoder: BeamSearchDecoder, inits=None,
                   max_step_num: int = 32, batch_size: Optional[int] = None,
                   **kwargs):
    """Run ``decoder`` until every beam has finished or ``max_step_num``
    steps: ``(ids, log_probs)``, the token ids (B, beam, T) backtraced by
    :func:`functional.gather_tree` and the final totals (B, beam).  Each
    step reads back whether all beams have finished."""
    enforce(batch_size is not None or inits is not None,
            "dynamic_decode needs inits or batch_size")
    if batch_size is None:
        batch_size = _leaves(inits)[0].shape[0]
    tokens, log_probs, finished, states = decoder.initialize(inits,
                                                             batch_size)
    ids_steps, parent_steps = [], []
    for _ in range(max_step_num):
        tokens, log_probs, finished, states, parent = decoder.step(
            tokens, log_probs, finished, states)
        ids_steps.append(tokens)
        parent_steps.append(parent)
        if bool(finished.all()):
            break
    seqs = F.gather_tree(torch.stack(ids_steps), torch.stack(parent_steps))
    return seqs.permute(1, 2, 0), log_probs
