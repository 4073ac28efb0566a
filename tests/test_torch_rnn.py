"""Port parity of the recurrent layers (``paddle_tpu_torch/nn/rnn.py``)
against the JAX package's ``paddle_tpu/nn/rnn.py`` on the CPU: the JAX
layer's weights go into the port's through ``convert.load_jax_state``,
the inputs are the same seeded numpy arrays.  Covered: ``SimpleRNN``
(tanh and relu), ``LSTM`` and ``GRU``, 1 and 2 layers, forward and
bidirectional, ``time_major`` both ways, with and without
``sequence_length`` (a row of length 0 and one of full length), with and
without ``initial_states``; the outputs, the final states and the
gradients of ``sum(out * ct) + sum(final * ct')`` with respect to every
weight, the input and the initial states; ``RNN`` / ``BiRNN`` over each
cell and a user's tuple-state cell; the cells alone; the state-dict keys,
shapes and dtypes; the inter-layer dropout's structure.

Tolerances: float32 on both sides, a recurrence of at most 7 steps at
widths 3-6: values within 1e-5 and gradients within 5e-5 of each tensor's
range (the gradients sum the step products back through the recurrence
in another order than XLA's scan).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_jax_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work (the suite's xdist
    workers oversubscribe the cores otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


VALUE_TOL, GRAD_TOL = 1e-5, 5e-5
B, T, IN, H = 3, 7, 5, 4
LENS = np.asarray([0, 7, 4])


def _a(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, ref, what, tol):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    bound = tol * max(float(np.abs(ref).max()), 1e-1)
    assert err <= bound, f"{what}: max |port - jax| {err:.3e} > {bound:.3e}"


def _jit(fn, *args):
    lowered = jax.jit(fn).lower(*args)
    return lowered.compile({"xla_backend_optimization_level": 0})(*args)


def _leaves(tree):
    return list(tree) if isinstance(tree, (tuple, list)) else [tree]


def _flat_final(final):
    """The final state's tensors, in order, whatever its nesting."""
    out = []
    for leaf in _leaves(final):
        out.extend(_flat_final(leaf) if isinstance(leaf, (tuple, list))
                   else [leaf])
    return out


def _port(jlayer, tlayer):
    load_jax_state(tlayer, {k: np.asarray(v)
                            for k, v in jlayer.state_dict().items()})
    return tlayer


def _parity(jlayer, tlayer, x, init=None, lens=None):
    """Outputs, final states and gradients of both layers on the numpy
    input ``x`` (and ``init``, a numpy array or tuple of them)."""
    params = jlayer.trainable_variables()
    init_list = [] if init is None else _leaves(init)
    kw = {} if lens is None else {"sequence_length": jnp.asarray(lens)}

    def pack(states):
        if init is None:
            return None
        return tuple(states) if isinstance(init, tuple) else states[0]

    out_shape, fin_shape = jax.eval_shape(
        lambda p, x, *s: jlayer.apply(p, x, initial_states=pack(s), **kw),
        params, jnp.asarray(x), *map(jnp.asarray, init_list))
    ct = _a(99, *out_shape.shape)
    fin_cts = [_a(100 + i, *f.shape)
               for i, f in enumerate(_flat_final(fin_shape))]

    def loss(p, x, *s):
        out, fin = jlayer.apply(p, x, initial_states=pack(s), **kw)
        total = (out * ct).sum() + sum((f * c).sum() for f, c in zip(
            _flat_final(fin), fin_cts))
        return total, (out, fin)
    argnums = tuple(range(2 + len(init_list)))
    (_, (jout, jfin)), jgrads = _jit(
        jax.value_and_grad(loss, argnums=argnums, has_aux=True), params,
        jnp.asarray(x), *map(jnp.asarray, init_list))

    tx = torch.from_numpy(x.copy()).requires_grad_()
    tinit = [torch.from_numpy(s.copy()).requires_grad_() for s in init_list]
    tkw = {} if lens is None else {"sequence_length": torch.from_numpy(lens)}
    tout, tfin = tlayer(tx, initial_states=pack(tinit), **tkw)
    _close(tout, jout, "output", VALUE_TOL)
    tfins, jfins = _flat_final(tfin), _flat_final(jfin)
    assert len(tfins) == len(jfins)
    for i, (t, j) in enumerate(zip(tfins, jfins)):
        _close(t, j, f"final state {i}", VALUE_TOL)
    total = (tout * torch.from_numpy(ct)).sum() + sum(
        (f * torch.from_numpy(c)).sum() for f, c in zip(tfins, fin_cts))
    total.backward()
    for name, p in tlayer.named_parameters():
        _close(p.grad, jgrads[0][name], f"grad {name}", GRAD_TOL)
    _close(tx.grad, jgrads[1], "grad input", GRAD_TOL)
    for i, s in enumerate(tinit):
        _close(s.grad, jgrads[2 + i], f"grad initial state {i}", GRAD_TOL)
    return tout, tfin


def _initial(kind, layers, bidirect):
    n = layers * (2 if bidirect else 1)
    if kind == "LSTM":
        return (_a(11, n, B, H), _a(12, n, B, H))
    return _a(13, n, B, H)


# (class, cell kwargs, layers, direction, time_major, lengths, init)
STACKED = []
for _cls, _kw in (("SimpleRNN", {}), ("SimpleRNN", {"activation": "relu"}),
                  ("LSTM", {}), ("GRU", {})):
    _tag = _cls + ("_relu" if _kw else "")
    STACKED += [
        pytest.param(_cls, _kw, 2, "bidirect", False, True, True,
                     id=f"{_tag}-2x-bidirect-lens-init"),
        pytest.param(_cls, _kw, 1, "forward", True, False, False,
                     id=f"{_tag}-1x-forward-time_major"),
        pytest.param(_cls, _kw, 1, "bidirect", True, True, False,
                     id=f"{_tag}-1x-bidirect-time_major-lens"),
        pytest.param(_cls, _kw, 2, "forward", False, False, True,
                     id=f"{_tag}-2x-forward-init"),
    ]


@pytest.mark.parametrize("cls,cell_kw,layers,direction,time_major,lens,"
                         "init", STACKED)
def test_stacked_rnn_matches_jax(cls, cell_kw, layers, direction,
                                 time_major, lens, init):
    pt.seed(3)
    jlayer = getattr(jnn, cls)(IN, H, num_layers=layers, direction=direction,
                               time_major=time_major, **cell_kw)
    tlayer = _port(jlayer, getattr(tnn, cls)(
        IN, H, num_layers=layers, direction=direction, time_major=time_major,
        device="cpu", **cell_kw))
    x = _a(1, T, B, IN) if time_major else _a(1, B, T, IN)
    tout, _ = _parity(jlayer, tlayer, x,
                      _initial(cls, layers, direction == "bidirect")
                      if init else None, LENS if lens else None)
    if lens:
        out = tout if time_major else tout.transpose(0, 1)
        # past a row's length (row 0 has none) the output is zero
        assert torch.count_nonzero(out[:, 0]) == 0
        assert torch.count_nonzero(out[4:, 2]) == 0


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
@pytest.mark.parametrize("wrapper", ["RNN", "BiRNN", "RNN_reverse"])
def test_rnn_wrappers_over_each_cell_match_jax(cell, wrapper):
    pt.seed(4)
    jcells = [getattr(jnn, cell)(IN, H) for _ in range(2)]
    tcells = [getattr(tnn, cell)(IN, H, device="cpu") for _ in range(2)]
    if wrapper == "BiRNN":
        jlayer, tlayer = jnn.BiRNN(*jcells), tnn.BiRNN(*tcells)
    else:
        rev = wrapper == "RNN_reverse"
        jlayer = jnn.RNN(jcells[0], is_reverse=rev)
        tlayer = tnn.RNN(tcells[0], is_reverse=rev)
    _port(jlayer, tlayer)
    _parity(jlayer, tlayer, _a(2, B, T, IN), lens=LENS)


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
def test_cells_match_jax_one_step(cell):
    pt.seed(5)
    jcell = getattr(jnn, cell)(IN, H)
    tcell = _port(jcell, getattr(tnn, cell)(IN, H, device="cpu"))
    x = _a(3, B, IN)
    state = (_a(4, B, H), _a(5, B, H)) if cell == "LSTMCell" else _a(4, B, H)
    jst = tuple(map(jnp.asarray, state)) if isinstance(state, tuple) \
        else jnp.asarray(state)
    tst = tuple(map(torch.from_numpy, state)) if isinstance(state, tuple) \
        else torch.from_numpy(state)
    jh, jnew = jcell(jnp.asarray(x), jst)
    th, tnew = tcell(torch.from_numpy(x), tst)
    _close(th, jh, "h", VALUE_TOL)
    for t, j in zip(_flat_final(tnew), _flat_final(jnew)):
        _close(t, j, "state", VALUE_TOL)


def test_custom_tuple_state_cell_runs_in_rnn():
    """A user's cell with a tuple state runs inside ``RNN``: every leaf of
    the state is carried past a row's length, as JAX's."""
    class JPeephole(jnn.LSTMCell):
        def get_initial_states(self, batch_size, dtype=jnp.float32):
            z = jnp.zeros((batch_size, self.hidden_size), dtype)
            return (z, z)

    class TPeephole(torch.nn.Module):
        """A tuple-state cell written against the protocol alone."""

        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def project_inputs(self, x):
            return self.inner.project_inputs(x)

        def step(self, xproj, state):
            return self.inner.step(xproj, state)

        def get_initial_states(self, batch_size, dtype=torch.float32):
            z = torch.zeros(batch_size, self.inner.hidden_size, dtype=dtype)
            return (z, z)

    pt.seed(6)
    jcell = JPeephole(IN, H)
    tcell = _port(jcell, tnn.LSTMCell(IN, H, device="cpu"))
    jlayer, tlayer = jnn.RNN(jcell), tnn.RNN(TPeephole(tcell))
    params = jlayer.trainable_variables()
    x = _a(7, B, T, IN)
    jout, (jh, jc) = jlayer.apply(params, jnp.asarray(x),
                                  sequence_length=jnp.asarray(LENS))
    tout, (th, tc) = tlayer(torch.from_numpy(x),
                            sequence_length=torch.from_numpy(LENS))
    _close(tout, jout, "output", VALUE_TOL)
    _close(th, jh, "h", VALUE_TOL)
    _close(tc, jc, "c", VALUE_TOL)
    assert torch.count_nonzero(tout[2, 4:]) == 0


@pytest.mark.parametrize("cls", ["SimpleRNN", "LSTM", "GRU"])
def test_state_dict_keys_shapes_dtypes_are_jax(cls):
    pt.seed(7)
    jsd = getattr(jnn, cls)(IN, H, num_layers=2,
                            direction="bidirect").state_dict()
    tsd = getattr(tnn, cls)(IN, H, num_layers=2, direction="bidirect",
                            device="cpu").state_dict()
    assert list(tsd) == list(jsd)
    for k, v in jsd.items():
        assert tuple(tsd[k].shape) == tuple(v.shape), k
        assert str(tsd[k].dtype).split(".")[-1] == str(v.dtype), k
    gates = {"SimpleRNN": 1, "LSTM": 4, "GRU": 3}[cls]
    assert tuple(tsd["cells.2.weight_ih"].shape) == (2 * H, gates * H)
    assert tuple(tsd["cells.0.weight_hh"].shape) == (H, gates * H)


def test_interlayer_dropout_draws_from_the_device_stream():
    """Training-mode dropout between layers: masks from the stream of
    ``framework/random.py`` (equal seeds, equal outputs; another seed,
    another output); eval is deterministic and equals p = 0."""
    from paddle_tpu_torch.framework import random as fw_random
    fw_random.seed(0)
    lstm = tnn.LSTM(IN, H, num_layers=2, dropout=0.5, device="cpu")
    x = torch.from_numpy(_a(8, B, T, IN))
    fw_random.seed(1)
    a, _ = lstm(x)
    fw_random.seed(1)
    b, _ = lstm(x)
    fw_random.seed(2)
    c, _ = lstm(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    lstm.eval()
    d, _ = lstm(x)
    lstm.dropout = 0.0
    e, _ = lstm(x)
    assert torch.equal(d, e)
