"""``paddle.static``: the static-graph facade, the port of
``paddle_tpu/static/__init__.py``.

The JAX package renders the static API on its one code path: a
``Program`` is a named scope around one Python function, which
``Executor.run`` jits.  The port keeps the same shape and runs the
function eagerly (PyTorch has no trace to make):

- ``static.data`` / ``InputSpec`` are feed declarations;
- ``Program.set_fn(fn)`` attaches ``fn(**feed)``; ``Program.run(feed)``
  calls it under ``program_guard`` with the feed as tensors on the current
  device; ``clone(for_test=True)`` runs the same layers in eval mode;
- the ``static.nn`` helpers create their layers on the current program at
  first use and find them again by build order (or ``name``) on every
  later run, so a program owns its parameters, as in the reference;
- ``save_inference_model`` / ``load_inference_model`` are the port's
  ``jit.save`` / ``jit.load`` artifact; a ``Program`` saves as a layer
  whose parameters are its ``static.nn`` layers', fed by name.
"""
from __future__ import annotations

import contextlib
import pickle
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..framework.dtype import as_tensor, convert_dtype, current_device
from ..framework.errors import enforce
from ..jit import InputSpec
from ..nn.layer import Layer

__all__ = ["InputSpec", "data", "Program", "program_guard",
           "default_main_program", "default_startup_program", "Executor",
           "save_inference_model", "load_inference_model", "nn",
           "Variable", "name_scope", "device_guard", "global_scope",
           "scope_guard", "cpu_places", "cuda_places", "xpu_places",
           "npu_places", "mlu_places", "create_global_var",
           "create_parameter", "Print", "py_func", "accuracy", "auc",
           "ExponentialMovingAverage", "WeightNormParamAttr",
           "BuildStrategy", "ExecutionStrategy", "CompiledProgram",
           "ParallelExecutor", "append_backward", "gradients", "save",
           "load", "serialize_program", "deserialize_program",
           "serialize_persistables", "deserialize_persistables",
           "save_to_file", "load_from_file", "normalize_program",
           "load_program_state", "set_program_state", "IpuStrategy",
           "IpuCompiledProgram", "ipu_shard_guard"]


def data(name: str, shape: Sequence[Optional[int]], dtype="float32"):
    """Feed declaration (reference static.data) -> InputSpec."""
    return InputSpec(shape, dtype=dtype, name=name)


class Program:
    """A named scope for one Python function (the rendering of
    ProgramDesc).  ``set_fn(fn)`` attaches ``fn(**feed) -> output``;
    ``run(feed)`` calls it.  The ``static.nn`` layers it builds live in
    ``_nn_layers``, keyed by slot (``<kind>_<build index>`` or the
    ``name`` given)."""

    def __init__(self, name: str = "main"):
        self.name = name
        self._fn: Optional[Callable] = None
        self._nn_layers: Dict[str, Any] = {}
        self._nn_counters: Dict[str, int] = {}
        self._for_test = False

    def _nn_slot(self, kind: str, name: Optional[str]) -> str:
        if name:
            return name
        idx = self._nn_counters.get(kind, 0)
        self._nn_counters[kind] = idx + 1
        return f"{kind}_{idx}"

    def set_fn(self, fn: Callable) -> "Program":
        self._fn = fn
        return self

    def _call(self, feed: Dict[str, Any]):
        """``fn(**feed)`` under this program, the build-order counters
        reset so every run walks the helpers in the same sequence."""
        self._nn_counters.clear()
        for layer in self._nn_layers.values():
            if isinstance(layer, torch.nn.Module):
                layer.train(not self._for_test)
        with program_guard(self):
            return self._fn(**feed)

    def run(self, feed: Dict[str, Any]):
        enforce(self._fn is not None,
                f"Program {self.name!r} has no function attached — build "
                "static programs as python functions (Program.set_fn); "
                "imperative op-building has no analog")
        return self._call({k: as_tensor(v) for k, v in feed.items()})

    def clone(self, for_test: bool = False) -> "Program":
        """The same function over the same layers; ``for_test`` runs them
        in eval mode (BatchNorm's running statistics, no dropout)."""
        p = Program(self.name)
        p._fn, p._nn_layers = self._fn, self._nn_layers
        p._for_test = bool(for_test)
        return p


_default_main = Program("main")
_default_startup = Program("startup")


def default_main_program() -> Program:
    return _default_main


def default_startup_program() -> Program:
    return _default_startup


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    """Makes ``main_program`` the default for the block, so the
    ``static.nn`` helpers resolve it."""
    global _default_main, _default_startup
    prev_m, prev_s = _default_main, _default_startup
    _default_main = main_program
    if startup_program is not None:
        _default_startup = startup_program
    try:
        yield
    finally:
        _default_main, _default_startup = prev_m, prev_s


def _numpy(o):
    return o.detach().cpu().numpy() if isinstance(o, torch.Tensor) \
        else np.asarray(o)


class Executor:
    """Reference static.Executor: ``run`` executes a Program (or a loaded
    inference program) on the feed; the place is the current device's."""

    def __init__(self, place=None):
        self.place = place

    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[List] = None, return_numpy: bool = True):
        program = program or default_main_program()
        out = program.run(feed or {})
        if isinstance(out, dict):
            outs = [out[k] for k in (fetch_list or list(out.keys()))]
        elif isinstance(out, (list, tuple)):
            outs = list(out)
        else:
            outs = [out]
        return [_numpy(o) for o in outs] if return_numpy else list(outs)


class _ProgramLayer(Layer):
    """A Program as a layer: its ``static.nn`` layers are sublayers (their
    parameters are the exported program's), ``forward(*inputs)`` feeds
    ``inputs`` by ``names`` and runs the program in eval mode."""

    def __init__(self, program: Program, names: Sequence[str]):
        super().__init__()
        enforce(program._fn is not None and program._nn_layers,
                f"Program {program.name!r} must have run once (its layers "
                "are made at the first run) before it is saved")
        self._program = program.clone(for_test=True)
        self._names = list(names)
        for slot, layer in program._nn_layers.items():
            self.add_sublayer(slot, layer)

    def forward(self, *inputs):
        return self._program._call(dict(zip(self._names, inputs)))


def save_inference_model(path_prefix: str, feed_vars, fetch_vars, executor,
                         *, layer=None, input_spec=None, **kw):
    """The ``jit.save`` artifact of ``layer``, or of a Program
    (``program=``, default the main program) fed by the specs' names."""
    from .. import jit as pt_jit
    specs = input_spec if input_spec is not None else feed_vars
    enforce(specs is not None,
            "save_inference_model needs input specs: pass "
            "input_spec=[InputSpec...] (or feed_vars from static.data)")
    specs = list(specs)
    if layer is None:
        program = kw.get("program") or default_main_program()
        layer = _ProgramLayer(program, [s.name or f"input_{i}"
                                        for i, s in enumerate(specs)])
    pt_jit.save(layer, path_prefix, input_spec=specs)


def load_inference_model(path_prefix: str, executor=None):
    """``(program, feed names, None)``; ``Executor.run(program, feed)``
    runs the loaded artifact."""
    from .. import jit as pt_jit
    loaded = pt_jit.load(path_prefix)
    feed_names = [s.name or f"input_{i}"
                  for i, s in enumerate(loaded.input_spec)]
    return loaded, feed_names, None


class _Params(Layer):
    """Parameters a helper creates directly (``weight``, ``bias``), kept
    as a layer so the program's state and export see them."""

    def __init__(self, **params):
        super().__init__()
        for k, v in params.items():
            if v is not None:
                self.add_parameter(k, v)
            else:
                setattr(self, k, None)


class _DataNorm(Layer):
    """data_norm's global accumulators (reference init: size and
    square_sum 1e4, sum 0), updated in place by every call."""

    def __init__(self, c: int, device):
        super().__init__()
        self.register_buffer("size", torch.full((c,), 1e4, device=device))
        self.register_buffer("sum", torch.zeros((c,), device=device))
        self.register_buffer("square_sum",
                             torch.full((c,), 1e4, device=device))


def _act(out, act):
    from ..nn import functional as F
    return getattr(F, act)(out) if act else out


def _param(shape, attr=None, is_bias=False, default_initializer=None):
    from .. import create_parameter as _cp
    return _cp(list(shape), "float32", attr=attr, is_bias=is_bias,
               default_initializer=default_initializer)


class nn:
    """paddle.static.nn: helpers that cache their layers on the current
    default Program by build order (or ``name``), so every run of the
    program reuses the same parameters."""

    @staticmethod
    def _layer(kind, name, build):
        prog = default_main_program()
        slot = prog._nn_slot(kind, name)
        if slot not in prog._nn_layers:
            prog._nn_layers[slot] = build()
        return prog._nn_layers[slot]

    @staticmethod
    def fc(x, size: int, num_flatten_dims: int = 1, weight_attr=None,
           bias_attr=None, activation=None, name=None):
        from ..nn.layers import Linear
        x = as_tensor(x)
        flat = x.reshape(*x.shape[:num_flatten_dims], -1)
        layer = nn._layer("fc", name, lambda: Linear(
            flat.shape[-1], size, weight_attr=weight_attr,
            bias_attr=bias_attr, device=x.device))
        return _act(layer(flat), activation)

    @staticmethod
    def embedding(input, size, is_sparse: bool = False, padding_idx=None,  # noqa: A002
                  param_attr=None, dtype="float32", name=None):
        from ..nn.layers import Embedding
        layer = nn._layer("embedding", name, lambda: Embedding(
            size[0], size[1], padding_idx=padding_idx,
            weight_attr=param_attr, device=input.device))
        return layer(input).to(convert_dtype(dtype))

    @staticmethod
    def batch_norm(input, act=None, momentum: float = 0.9,  # noqa: A002
                   epsilon: float = 1e-5, data_layout: str = "NCHW",
                   name=None, **kw):
        from ..nn.layers import BatchNorm2D
        enforce(not kw, f"batch_norm got unsupported kwargs {sorted(kw)}")
        features = input.shape[1] if data_layout == "NCHW" \
            else input.shape[-1]
        layer = nn._layer("batch_norm", name, lambda: BatchNorm2D(
            features, momentum=momentum, epsilon=epsilon,
            data_format=data_layout, device=input.device))
        return _act(layer(input), act)

    @staticmethod
    def conv2d(input, num_filters: int, filter_size, stride=1, padding=0,  # noqa: A002
               dilation=1, groups: int = 1, param_attr=None, bias_attr=None,
               act=None, data_format: str = "NCHW", name=None):
        from ..nn.layers import Conv2D
        cin = input.shape[1] if data_format == "NCHW" else input.shape[-1]
        k = filter_size if isinstance(filter_size, int) else tuple(filter_size)
        layer = nn._layer("conv2d", name, lambda: Conv2D(
            cin, num_filters, k, stride=stride, padding=padding,
            dilation=dilation, groups=groups, weight_attr=param_attr,
            bias_attr=bias_attr, data_format=data_format,
            device=input.device))
        return _act(layer(input), act)

    @staticmethod
    def conv3d(input, num_filters: int, filter_size, stride=1, padding=0,  # noqa: A002
               dilation=1, groups: int = 1, param_attr=None, bias_attr=None,
               act=None, data_format: str = "NCDHW", name=None):
        from ..nn.layers import Conv3D
        layer = nn._layer("conv3d", name, lambda: Conv3D(
            input.shape[1], num_filters, filter_size, stride=stride,
            padding=padding, dilation=dilation, groups=groups,
            weight_attr=param_attr, bias_attr=bias_attr,
            device=input.device))
        return _act(layer(input), act)

    @staticmethod
    def _transpose_kernel(in_sp, output_size, stride, padding, dilation,
                          nd):
        """The kernel that gives ``output_size``: out = (in - 1) s - 2 p +
        d (k - 1) + 1."""
        def tup(v):
            return (v,) * nd if isinstance(v, int) else tuple(v)
        out = tup(output_size)
        s_, p_, d_ = tup(stride), tup(padding), tup(dilation)
        k = []
        for i in range(nd):
            num = out[i] - (in_sp[i] - 1) * s_[i] + 2 * p_[i] - 1
            enforce(num % d_[i] == 0 and num // d_[i] + 1 >= 1,
                    f"output_size {out[i]} unreachable from input "
                    f"{in_sp[i]} with stride {s_[i]} padding {p_[i]}")
            k.append(num // d_[i] + 1)
        return tuple(k)

    @staticmethod
    def conv2d_transpose(input, num_filters: int, filter_size=None,  # noqa: A002
                         output_size=None, stride=1, padding=0, dilation=1,
                         groups: int = 1, param_attr=None, bias_attr=None,
                         act=None, data_format: str = "NCHW", name=None):
        from ..nn.layers import Conv2DTranspose
        if filter_size is None:
            enforce(output_size is not None,
                    "conv2d_transpose needs filter_size or output_size")
            filter_size = nn._transpose_kernel(
                tuple(input.shape[2:]), output_size, stride, padding,
                dilation, 2)
        layer = nn._layer("conv2d_transpose", name, lambda: Conv2DTranspose(
            input.shape[1], num_filters, filter_size, stride=stride,
            padding=padding, dilation=dilation, groups=groups,
            weight_attr=param_attr, bias_attr=bias_attr,
            device=input.device))
        return _act(layer(input), act)

    @staticmethod
    def conv3d_transpose(input, num_filters: int, filter_size=None,  # noqa: A002
                         output_size=None, stride=1, padding=0, dilation=1,
                         groups: int = 1, param_attr=None, bias_attr=None,
                         act=None, data_format: str = "NCDHW", name=None):
        from ..nn.layers_ext import Conv3DTranspose
        if filter_size is None:
            enforce(output_size is not None,
                    "conv3d_transpose needs filter_size or output_size")
            filter_size = nn._transpose_kernel(
                tuple(input.shape[2:]), output_size, stride, padding,
                dilation, 3)
        layer = nn._layer("conv3d_transpose", name, lambda: Conv3DTranspose(
            input.shape[1], num_filters, filter_size, stride=stride,
            padding=padding, dilation=dilation, groups=groups,
            weight_attr=param_attr, bias_attr=bias_attr,
            device=input.device))
        return _act(layer(input), act)

    @staticmethod
    def deform_conv2d(input, offset, mask, num_filters: int, filter_size,  # noqa: A002
                      stride=1, padding=0, dilation=1, groups: int = 1,
                      deformable_groups: int = 1, im2col_step: int = 1,
                      param_attr=None, bias_attr=None, name=None):
        from ..vision.ops import deform_conv2d as _dc
        cin = input.shape[1]
        k = (filter_size, filter_size) if isinstance(filter_size, int) \
            else tuple(filter_size)
        p = nn._layer("deform_conv2d", name, lambda: _Params(
            weight=_param([num_filters, cin // groups, *k], param_attr),
            bias=None if bias_attr is False else _param(
                [num_filters], bias_attr, is_bias=True)))
        return _dc(input, offset, p.weight, bias=p.bias, stride=stride,
                   padding=padding, dilation=dilation, groups=groups,
                   deformable_groups=deformable_groups, mask=mask)

    @staticmethod
    def layer_norm(input, scale: bool = True, shift: bool = True,  # noqa: A002
                   begin_norm_axis: int = 1, epsilon: float = 1e-5,
                   param_attr=None, bias_attr=None, act=None, name=None):
        from ..nn import functional as F
        from ..nn.initializer import Constant
        x = as_tensor(input)
        shape = list(x.shape[begin_norm_axis:])
        p = nn._layer("layer_norm", name, lambda: _Params(
            weight=_param(shape, param_attr,
                          default_initializer=Constant(1.0))
            if scale else None,
            bias=_param(shape, bias_attr, is_bias=True) if shift else None))
        return _act(F.layer_norm(x, shape, p.weight, p.bias, epsilon), act)

    @staticmethod
    def group_norm(input, groups: int, epsilon: float = 1e-5,  # noqa: A002
                   param_attr=None, bias_attr=None, act=None,
                   data_layout: str = "NCHW", name=None):
        from ..nn.layers import GroupNorm
        enforce(data_layout == "NCHW",
                "static.nn.group_norm supports NCHW (the functional "
                "group_norm is channel-first)")
        layer = nn._layer("group_norm", name, lambda: GroupNorm(
            groups, input.shape[1], epsilon=epsilon, weight_attr=param_attr,
            bias_attr=bias_attr, device=input.device))
        return _act(layer(input), act)

    @staticmethod
    def instance_norm(input, epsilon: float = 1e-5, param_attr=None,  # noqa: A002
                      bias_attr=None, name=None):
        from ..nn.layers import InstanceNorm2D
        layer = nn._layer("instance_norm", name, lambda: InstanceNorm2D(
            input.shape[1], epsilon=epsilon, weight_attr=param_attr,
            bias_attr=bias_attr, device=input.device))
        return layer(input)

    @staticmethod
    def data_norm(input, act=None, epsilon: float = 1e-5, param_attr=None,  # noqa: A002
                  name=None, **kw):
        """Normalize by the GLOBAL running statistics (batch sum, square
        sum and size accumulated over every call, this one included),
        never the batch's own."""
        x = as_tensor(input)
        c = x.shape[1]
        axes = tuple(i for i in range(x.dim()) if i != 1)
        st = nn._layer("data_norm", name, lambda: _DataNorm(c, x.device))
        st.size.add_(x.numel() // c)
        st.sum.add_(x.sum(dim=axes))
        st.square_sum.add_(x.square().sum(dim=axes))
        mean = st.sum / st.size
        var = st.square_sum / st.size - mean.square()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        out = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape)
                                                     + epsilon)
        return _act(out, act)

    @staticmethod
    def prelu(x, mode: str = "all", param_attr=None, name=None):
        from ..nn.layers import PReLU
        layer = nn._layer("prelu", name, lambda: PReLU(
            num_parameters=1 if mode == "all" else x.shape[1],
            weight_attr=param_attr, device=x.device))
        return layer(x)

    @staticmethod
    def spectral_norm(weight, dim: int = 0, power_iters: int = 1,
                      eps: float = 1e-12, name=None):
        from ..nn.layers import SpectralNorm
        layer = nn._layer("spectral_norm", name, lambda: SpectralNorm(
            list(weight.shape), dim=dim, power_iters=power_iters,
            epsilon=eps, device=weight.device))
        return layer(weight)

    @staticmethod
    def bilinear_tensor_product(x, y, size: int, act=None, name=None,
                                param_attr=None, bias_attr=None):
        from ..nn.layers_ext import Bilinear
        layer = nn._layer("bilinear_tensor_product", name, lambda: Bilinear(
            x.shape[-1], y.shape[-1], size, weight_attr=param_attr,
            bias_attr=bias_attr, device=x.device))
        return _act(layer(x, y), act)

    @staticmethod
    def row_conv(input, future_context_size: int, param_attr=None,  # noqa: A002
                 act=None):
        """Lookahead row convolution: each step mixes the next
        ``future_context_size`` steps per feature."""
        x = as_tensor(input)                      # (B, T, D)
        k = future_context_size + 1
        p = nn._layer("row_conv", None, lambda: _Params(
            weight=_param([k, x.shape[-1]], param_attr)))
        pad = torch.nn.functional.pad(x, (0, 0, 0, future_context_size))
        out = sum(pad[:, i:i + x.shape[1], :] * p.weight[i][None, None, :]
                  for i in range(k))
        return _act(out, act)

    @staticmethod
    def nce(input, label, num_total_classes: int, num_neg_samples: int = 10,  # noqa: A002
            param_attr=None, bias_attr=None, name=None, sample_weight=None,
            sampler: str = "uniform", custom_dist=None, seed: int = 0,
            is_sparse: bool = False):
        """Noise-contrastive estimation loss: one positive and
        ``num_neg_samples`` uniform negatives a row (drawn from the
        framework's stream), logistic losses; (B, 1)."""
        from ..framework import random as fw_random
        x = as_tensor(input)                      # (B, D)
        y = as_tensor(label, like=x).reshape(-1).long()
        d = x.shape[-1]
        p = nn._layer("nce", name, lambda: _Params(
            weight=_param([num_total_classes, d], param_attr),
            bias=_param([num_total_classes], bias_attr, is_bias=True)))
        neg = torch.randint(0, num_total_classes,
                            (x.shape[0], num_neg_samples),
                            generator=fw_random.generator(x.device),
                            device=x.device)
        pos_logit = (x * p.weight[y]).sum(-1) + p.bias[y]
        neg_logit = torch.einsum("bd,bkd->bk", x, p.weight[neg]) \
            + p.bias[neg]
        logsig = torch.nn.functional.logsigmoid
        loss = -logsig(pos_logit) - logsig(-neg_logit).sum(dim=1)
        return loss[:, None]

    @staticmethod
    def sparse_embedding(input, size, padding_idx=None, param_attr=None,  # noqa: A002
                         is_test: bool = False, name=None, **kw):
        """The parameter server's lookup table: a plain embedding here (no
        parameter server; the lookup is the same)."""
        return nn.embedding(input, size, padding_idx=padding_idx,
                            param_attr=param_attr, name=name)

    @staticmethod
    def crf_decoding(input, param_attr=None, label=None, length=None,  # noqa: A002
                     name=None):
        """Viterbi decoding with a program-owned (n + 2, n) transition
        matrix (rows 0 / 1 the start / stop scores), through
        ``text.viterbi_decode``'s BOS / EOS convention."""
        from ..text import viterbi_decode
        x = as_tensor(input)
        n = x.shape[-1]
        p = nn._layer("crf_decoding", name, lambda: _Params(
            weight=_param([n + 2, n], param_attr)))
        trans = p.weight
        full = torch.zeros((n + 2, n + 2), dtype=torch.float32,
                           device=x.device)
        full[:n, :n] = trans[2:]
        full[n, :n] = trans[0]                    # BOS row
        full[:n, n + 1] = trans[1]                # EOS column
        _, path = viterbi_decode(
            torch.nn.functional.pad(x, (0, 2), value=-1e4), full,
            lengths=length, include_bos_eos_tag=True)
        return path

    # -- control flow: eager Python (reference static/nn/control_flow.py) --
    @staticmethod
    def cond(pred, true_fn=None, false_fn=None, name=None):
        fn = true_fn if bool(pred) else false_fn
        return fn() if fn is not None else None

    @staticmethod
    def while_loop(cond, body, loop_vars, is_test: bool = False, name=None):
        vs = tuple(loop_vars)
        while bool(cond(*vs)):
            vs = tuple(body(*vs))
        return list(vs)

    @staticmethod
    def case(pred_fn_pairs, default=None, name=None):
        """First true predicate wins; else ``default`` (or the last
        branch when there is none, as the JAX rendering)."""
        pairs = list(pred_fn_pairs)
        for pred, fn in pairs:
            if bool(pred):
                return fn()
        if default is not None:
            return default()
        return pairs[-1][1]()

    @staticmethod
    def switch_case(branch_index, branch_fns, default=None, name=None):
        """An exact key match of a dict runs its branch, anything else the
        default (or the last branch); a list index is clipped into range
        with the default appended."""
        idx = int(branch_index)
        if isinstance(branch_fns, dict):
            keys = sorted(branch_fns)
            if idx in branch_fns:
                return branch_fns[idx]()
            return default() if default is not None \
                else branch_fns[keys[-1]]()
        fns = list(branch_fns) + ([default] if default is not None else [])
        return fns[min(max(idx, 0), len(fns) - 1)]()

    @staticmethod
    def py_func(func, x, out, backward_func=None,
                skip_vars_in_backward_input=None):
        return py_func(func, x, out, backward_func,
                       skip_vars_in_backward_input)

    # -- LoD sequences as a padded batch plus a lengths vector -------------
    @staticmethod
    def _mask(x, length):
        t = x.shape[1]
        ln = as_tensor(length, like=x).reshape(-1)
        return torch.arange(t, device=x.device)[None, :] < ln[:, None]

    @staticmethod
    def _expand(m, ndim: int):
        while m.dim() < ndim:
            m = m[..., None]
        return m

    @staticmethod
    def sequence_softmax(input, length=None, use_cudnn=False, name=None):  # noqa: A002
        x = as_tensor(input)                      # (B, T)
        if length is None:
            return torch.softmax(x, dim=1)
        m = nn._mask(x, length)
        return torch.softmax(torch.where(m, x, torch.full_like(x, -1e30)),
                             dim=1) * m

    @staticmethod
    def sequence_pool(input, pool_type: str, length=None, is_test=False,  # noqa: A002
                      pad_value: float = 0.0):
        x = as_tensor(input)                      # (B, T, D) or (B, T)
        if length is None:
            length = torch.full((x.shape[0],), x.shape[1], device=x.device)
        length = as_tensor(length, like=x).reshape(-1)
        m = nn._expand(nn._mask(x, length), x.dim())
        cnt = torch.clamp(length, min=1).to(x.dtype)
        shaped = cnt.reshape((-1,) + (1,) * (x.dim() - 2))
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        pt = pool_type.lower()
        if pt == "sum":
            out = torch.where(m, x, zero).sum(dim=1)
        elif pt == "average":
            out = torch.where(m, x, zero).sum(dim=1) / shaped
        elif pt == "sqrt":
            out = torch.where(m, x, zero).sum(dim=1) / torch.sqrt(shaped)
        elif pt == "max":
            out = torch.where(m, x, torch.full((), -float("inf"),
                                               dtype=x.dtype,
                                               device=x.device)).amax(dim=1)
        elif pt == "last":
            idx = (length - 1).long().clamp(min=0)
            out = torch.gather(x, 1, idx.reshape(
                (-1, 1) + (1,) * (x.dim() - 2)).expand(
                    (-1, 1) + tuple(x.shape[2:]))).squeeze(1)
        elif pt == "first":
            out = x[:, 0]
        else:
            enforce(False, f"unknown pool_type {pool_type!r}")
        empty = (length == 0).reshape((-1,) + (1,) * (out.dim() - 1))
        return torch.where(empty, torch.full((), pad_value, dtype=out.dtype,
                                             device=out.device), out)

    @staticmethod
    def sequence_first_step(input, length=None):  # noqa: A002
        return nn.sequence_pool(input, "first", length)

    @staticmethod
    def sequence_last_step(input, length=None):  # noqa: A002
        return nn.sequence_pool(input, "last", length)

    @staticmethod
    def sequence_conv(input, num_filters: int, filter_size: int = 3,  # noqa: A002
                      filter_stride: int = 1, padding: bool = True,
                      padding_start=None, param_attr=None, bias_attr=None,
                      act=None, name=None):
        """Context-window convolution over time: ``filter_size`` steps
        from ``padding_start`` (default -(size - 1) // 2) feed one
        projection."""
        x = as_tensor(input)                      # (B, T, D)
        d, t = x.shape[-1], x.shape[1]
        start = padding_start if padding_start is not None \
            else -((filter_size - 1) // 2)
        p = nn._layer("sequence_conv", name, lambda: _Params(
            weight=_param([filter_size * d, num_filters], param_attr),
            bias=None if bias_attr is False else _param(
                [num_filters], bias_attr, is_bias=True)))
        ctx = []
        for i in range(filter_size):
            off = start + i
            idx = torch.arange(t, device=x.device) + off
            valid = ((idx >= 0) & (idx < t))[None, :, None]
            ctx.append(torch.where(valid, torch.roll(x, -off, dims=1),
                                   torch.zeros((), dtype=x.dtype,
                                               device=x.device)))
        out = torch.cat(ctx, dim=-1) @ p.weight
        if p.bias is not None:
            out = out + p.bias
        return _act(out, act)

    @staticmethod
    def sequence_concat(input, name=None):  # noqa: A002
        return torch.cat([as_tensor(x) for x in input], dim=1)

    @staticmethod
    def sequence_slice(input, offset, length, name=None):  # noqa: A002
        """Per-row slice [offset, offset + length) along time; ``length``
        must be uniform."""
        x = as_tensor(input)
        off = as_tensor(offset, like=x).reshape(-1).long()
        ln = int(as_tensor(length, like=x).reshape(-1)[0])
        idx = off[:, None] + torch.arange(ln, device=x.device)[None, :]
        idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
            tuple(idx.shape) + tuple(x.shape[2:]))
        return torch.gather(x, 1, idx)

    @staticmethod
    def sequence_expand(x, y, ref_level: int = -1, name=None):
        """Each row of x repeated ``y.shape[1]`` times (uniform repeat)."""
        n = y.shape[1] if hasattr(y, "shape") else int(y)
        return torch.repeat_interleave(as_tensor(x), n, dim=0)

    @staticmethod
    def sequence_expand_as(x, y, name=None):
        x = as_tensor(x)
        return torch.repeat_interleave(x, y.shape[0] // x.shape[0], dim=0)

    @staticmethod
    def sequence_pad(x, pad_value, maxlen=None, length=None, name=None):
        """A (B, T, ...) batch padded out to ``maxlen`` steps, positions
        past each length set to ``pad_value``; ``(padded, lengths)``."""
        x = as_tensor(x)
        t = x.shape[1]
        if length is None:
            length = torch.full((x.shape[0],), t, dtype=torch.int32,
                                device=x.device)
        length = as_tensor(length, like=x)
        tgt = maxlen or t
        pad = [0, 0] * (x.dim() - 2) + [0, max(0, tgt - t)]
        out = torch.nn.functional.pad(x, pad, value=float(pad_value))[:, :tgt]
        m = nn._expand(nn._mask(out, length), out.dim())
        return torch.where(m, out, torch.full((), float(pad_value),
                                              dtype=out.dtype,
                                              device=out.device)), length

    @staticmethod
    def sequence_unpad(x, length, name=None):
        """Positions past each length zeroed (a padded batch stays one
        tensor)."""
        x = as_tensor(x)
        m = nn._expand(nn._mask(x, length), x.dim())
        return torch.where(m, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))

    @staticmethod
    def sequence_reshape(input, new_dim: int, name=None):  # noqa: A002
        x = as_tensor(input)
        return x.reshape(x.shape[0], -1, new_dim)

    @staticmethod
    def sequence_reverse(x, length=None, name=None):
        """Each row's real prefix reversed, the padding left in place."""
        x = as_tensor(x)
        t = x.shape[1]
        if length is None:
            return torch.flip(x, dims=[1])
        ln = as_tensor(length, like=x).reshape(-1, 1).long()
        pos = torch.arange(t, device=x.device)[None, :]
        src = torch.where(pos < ln, ln - 1 - pos, pos)
        src = src.reshape(src.shape + (1,) * (x.dim() - 2)).expand(
            tuple(src.shape) + tuple(x.shape[2:]))
        return torch.gather(x, 1, src)

    @staticmethod
    def sequence_scatter(input, index, updates, name=None):  # noqa: A002
        x = as_tensor(input).clone()
        idx = as_tensor(index, like=x).long()
        upd = as_tensor(updates, like=x).to(x.dtype)
        rows = torch.arange(x.shape[0], device=x.device)[:, None] \
            .expand_as(idx)
        x.index_put_((rows, idx), upd, accumulate=True)
        return x

    @staticmethod
    def sequence_enumerate(input, win_size: int, pad_value: int = 0,  # noqa: A002
                           name=None):
        """Sliding windows of ids: (B, T) -> (B, T, win_size), the tail
        windows padded."""
        x = as_tensor(input)
        t = x.shape[1]
        cols = torch.arange(t, device=x.device)[:, None] \
            + torch.arange(win_size, device=x.device)[None, :]
        g = x[:, cols.clamp(max=t - 1)]
        return torch.where((cols < t)[None], g,
                           torch.full((), pad_value, dtype=x.dtype,
                                      device=x.device))

    @staticmethod
    def multi_box_head(inputs, image, num_classes: int, base_size=None,
                       aspect_ratios=None, min_ratio=None, max_ratio=None,
                       min_sizes=None, max_sizes=None, **kw):
        """SSD multi-box head: one 3x3 conv pair a feature map for box
        deltas and class scores, over priors on the map's grid
        (location-major, prior-minor, as the NHWC-reshaped heads emit)."""
        from ..nn.layers import Conv2D
        aspect_ratios = aspect_ratios or [[1.0]] * len(inputs)
        locs, confs, boxes = [], [], []
        for i, feat in enumerate(inputs):
            pr = len(aspect_ratios[i]) + 1
            c, dev = feat.shape[1], feat.device
            loc_l = nn._layer(f"mbox_loc_{i}", None, lambda c=c, pr=pr, d=dev:
                              Conv2D(c, pr * 4, 3, padding=1, device=d))
            conf_l = nn._layer(f"mbox_conf_{i}", None,
                               lambda c=c, pr=pr, d=dev: Conv2D(
                                   c, pr * num_classes, 3, padding=1,
                                   device=d))
            n, _, h, w = feat.shape
            locs.append(loc_l(feat).permute(0, 2, 3, 1).reshape(n, -1, 4))
            confs.append(conf_l(feat).permute(0, 2, 3, 1).reshape(
                n, -1, num_classes))
            ys, xs = torch.meshgrid(
                (torch.arange(h, device=dev) + 0.5) / h,
                (torch.arange(w, device=dev) + 0.5) / w, indexing="ij")
            s = 1.0 / (2 ** i * 2)
            per_cell = []
            for r in [1.0] + list(aspect_ratios[i]):
                bw, bh = s * (r ** 0.5), s / (r ** 0.5)
                per_cell.append(torch.stack(
                    [xs - bw / 2, ys - bh / 2, xs + bw / 2, ys + bh / 2],
                    dim=-1))
            boxes.append(torch.stack(per_cell, dim=2).reshape(-1, 4))
        prior = torch.cat(boxes, dim=0)
        var = torch.tensor([0.1, 0.1, 0.2, 0.2],
                           device=prior.device).expand_as(prior)
        return (torch.cat(locs, dim=1), torch.cat(confs, dim=1), prior,
                var)


# ---------------------------------------------------------------------------
# The rest of the static surface (reference static/__init__.py __all__)
# ---------------------------------------------------------------------------
Variable = InputSpec      # the declared-tensor role in this facade


def name_scope(prefix: str = None):
    """A name prefix for ops: naming only here (a context manager)."""
    return contextlib.nullcontext(prefix)


def device_guard(device: str = None):
    """An op placement hint: accepted and ignored (ops run where their
    tensors are)."""
    return contextlib.nullcontext(device)


class _Scope(dict):
    def var(self, name):
        return self.setdefault(name, None)

    def find_var(self, name):
        return self.get(name)


_global_scope = _Scope()


def global_scope() -> _Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope: _Scope):
    global _global_scope
    prev = _global_scope
    _global_scope = scope
    try:
        yield scope
    finally:
        _global_scope = prev


def cpu_places(device_count: Optional[int] = None):
    from ..framework.dtype import CPUPlace
    return [CPUPlace() for _ in range(device_count or 1)]


def cuda_places(device_ids=None):
    """The cards (``CUDAPlace``), all visible ones by default."""
    from ..framework.dtype import CUDAPlace
    ids = device_ids if device_ids is not None \
        else range(torch.cuda.device_count())
    return [CUDAPlace(i) for i in ids]


xpu_places = cuda_places
npu_places = cuda_places
mlu_places = cuda_places


def create_global_var(shape, value, dtype, persistable: bool = False,
                      force_cpu: bool = False, name=None):
    """A named global tensor in the current scope."""
    v = torch.full(tuple(shape), value, dtype=convert_dtype(dtype),
                   device="cpu" if force_cpu else current_device())
    _global_scope[name or f"gvar_{len(_global_scope)}"] = v
    return v


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from .. import create_parameter as _cp
    return _cp(shape, dtype, name=name, attr=attr, is_bias=is_bias,
               default_initializer=default_initializer)


def Print(input, first_n: int = -1, message: Optional[str] = None,  # noqa: A002,N802
          summarize: int = 20, print_tensor_name: bool = True, **kw):
    """Print a tensor as the program runs; returns it."""
    print((message or "") + f" {input}")
    return input


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """A host Python op: ``func`` on the inputs, its result as tensors of
    ``out``'s shapes and dtypes on their device."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    res = func(*xs)

    def like(r, o):
        return as_tensor(r, like=o, dtype=o.dtype).reshape(o.shape)
    if isinstance(out, (list, tuple)):
        return type(out)(like(r, o) for r, o in zip(res, out))
    return like(res, out)


def accuracy(input, label, k: int = 1, **kw):  # noqa: A002
    """Top-k accuracy of one batch."""
    x = as_tensor(input)
    topk = torch.argsort(x, dim=-1, stable=True)[..., -k:]
    lbl = as_tensor(label, like=x).reshape(-1, 1)
    return (topk == lbl).any(dim=-1).to(torch.float32).mean()


def auc(input, label, curve: str = "ROC", num_thresholds: int = 4095,  # noqa: A002
        **kw):
    """AUC over one batch (no streaming state)."""
    from ..metric import Auc
    m = Auc(num_thresholds=num_thresholds)
    m.update(input, label)
    return torch.tensor(m.accumulate(), dtype=torch.float32)


class ExponentialMovingAverage:
    """Shadow parameters ``ema = decay * ema + (1 - decay) * param`` with
    bias correction: ``update(params)`` folds a step in, ``shadow()``
    returns the corrected averages, ``apply()`` yields them."""

    def __init__(self, decay: float = 0.999, thres_steps=None, name=None):
        self._decay = decay
        self._ema = None
        self._step = 0

    def update(self, params):
        params = {k: as_tensor(v).detach() for k, v in params.items()}
        if self._ema is None:
            self._ema = {k: torch.zeros_like(v) for k, v in params.items()}
        d = self._decay
        self._ema = {k: d * self._ema[k] + (1 - d) * params[k]
                     for k in params}
        self._step += 1

    def shadow(self):
        enforce(self._ema is not None, "EMA.update never called")
        corr = 1 - self._decay ** self._step
        return {k: v / corr for k, v in self._ema.items()}

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore: bool = True):
        yield self.shadow()

    def restore(self, executor=None):
        pass


class WeightNormParamAttr:
    """A ParamAttr asking for weight normalization (the dygraph path is
    ``nn.utils.weight_norm``): records ``dim`` and the attr fields."""

    def __init__(self, dim=None, name=None, initializer=None, trainable=True,
                 **kw):
        self.dim = dim
        self.name = name
        self.initializer = initializer
        self.trainable = trainable


class BuildStrategy:
    """Graph-pass configuration: the knobs are recorded (no pass pipeline
    to configure)."""

    def __init__(self):
        self.__dict__["_opts"] = {}

    def __setattr__(self, k, v):
        self._opts[k] = v

    def __getattr__(self, k):
        return self.__dict__.get("_opts", {}).get(k, False)


class ExecutionStrategy(BuildStrategy):
    pass


class CompiledProgram:
    """``CompiledProgram(program).with_data_parallel(...)``: runs the
    wrapped Program (one card)."""

    def __init__(self, program, build_strategy=None):
        self._program = program

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, places=None):
        return self

    def run(self, feed):
        return self._program.run(feed)


class ParallelExecutor(CompiledProgram):
    def __init__(self, use_cuda: bool = False, loss_name=None,
                 main_program=None, build_strategy=None,
                 exec_strategy=None, scope=None, share_vars_from=None):
        super().__init__(main_program or default_main_program())


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Pre-2.0 graph surgery: raises with the eager recipe."""
    raise NotImplementedError(
        "append_backward rewrites a ProgramDesc; in this runtime the "
        "backward is torch's tape over the program's python function — "
        "call loss.backward() or paddle_tpu_torch.autograd.grad.")


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    raise NotImplementedError(
        "static.gradients rewrites a ProgramDesc; use "
        "paddle_tpu_torch.autograd.grad (or torch.autograd.grad) over the "
        "inputs.")


def _program_state(program: Program) -> Dict[str, Dict[str, Any]]:
    return {k: l.state_dict() for k, l in program._nn_layers.items()
            if isinstance(l, torch.nn.Module)}


def _set_state(program: Program, state) -> None:
    for k, sub in state.items():
        layer = program._nn_layers.get(k)
        if isinstance(layer, torch.nn.Module):
            layer.set_state_dict(sub)


def save(program: Program, model_path: str, protocol: int = 4):
    """The program's ``static.nn`` layers' state, by slot, at
    ``model_path + ".pdparams"``."""
    from ..framework.io import save as _save
    _save(_program_state(program), model_path + ".pdparams")


def load(program: Program, model_path: str, executor=None, var_list=None):
    from ..framework.io import load as _load
    state = _load(model_path + ".pdparams")
    _set_state(program, state)
    return state


def serialize_program(feed_vars, fetch_vars, **kwargs) -> bytes:
    return pickle.dumps({"feed": [getattr(v, "name", None)
                                  for v in feed_vars],
                         "fetch": [getattr(v, "name", None)
                                   for v in fetch_vars]})


def deserialize_program(data: bytes):
    return pickle.loads(data)


def serialize_persistables(feed_vars, fetch_vars, executor=None) -> bytes:
    state = {k: {n: _numpy(t) for n, t in sub.items()}
             for k, sub in _program_state(default_main_program()).items()}
    return pickle.dumps(state)


def deserialize_persistables(program, data: bytes, executor=None):
    state = pickle.loads(data)
    _set_state(program, state)
    return state


def save_to_file(path: str, content: bytes):
    from ..utils import fsio
    fsio.write_bytes(path, content)


def load_from_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def normalize_program(program, feed_vars, fetch_vars):
    return program


def load_program_state(model_path: str, var_list=None):
    from ..framework.io import load as _load
    return _load(model_path + ".pdparams")


def set_program_state(program, state_dict):
    _set_state(program, state_dict)


class IpuStrategy:
    """IPU configuration shell (no IPU backend): keeps ported scripts
    importable."""

    def __init__(self):
        self._opts = {}

    def set_graph_config(self, **kw):
        self._opts.update(kw)


class IpuCompiledProgram(CompiledProgram):
    pass


def ipu_shard_guard(index: int = -1, stage: int = -1):
    return contextlib.nullcontext()
