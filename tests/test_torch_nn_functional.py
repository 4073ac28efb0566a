"""Port parity of the rest of ``nn.functional`` (``paddle_tpu_torch/nn/
functional.py`` and ``_functional_ext.py``) against the JAX package's on
the CPU, over the case table ``paddle_tpu_torch.testing.nn_cases``: the
same seeded numpy inputs through both functions, then the gradients of
``sum(out * ct)`` (ct seeded) with respect to the case's float inputs.
``ctc_loss``'s gradient is taken with respect to ``log_probs`` itself;
``interpolate`` / ``upsample`` are held against ``jax.image.resize`` at
sizes that shrink and grow, in both layouts.

Tolerances: float32 on both sides; every value and gradient within 1e-5
of its tensor's range (absolute floor 1e-6), except the cases in
``LOOSER`` (each says why); integer outputs exact.  Random ops are held
by their statistics and structure (keep rates, alpha dropout's moments,
gumbel-softmax's one-hot rows and straight-through gradient, which
channels the channel dropouts zero), ``class_center_sample`` by equal
samples from equal seeds.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as jF
from paddle_tpu_torch.framework import random as fw_random
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.testing.nn_cases import functional_cases


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work (the suite's xdist
    workers oversubscribe the cores otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 1e-5
# cases that need more than TOL of the range, and why
LOOSER = {
}
CASES = functional_cases()


def _tol(name):
    return max([v for k, v in LOOSER.items() if name.startswith(k)]
               + [TOL])


def _close(got, ref, what, tol):
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if not np.issubdtype(ref.dtype, np.floating):
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    bound = tol * max(float(np.abs(ref).max()) if ref.size else 0.0, 1e-1)
    assert err <= bound, f"{what}: max |port - jax| {err:.3e} > {bound:.3e}"


def _outs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _jit(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at XLA's backend optimisation level
    0: one quick compile a case instead of an eager compile an op."""
    lowered = jax.jit(fn).lower(*args)
    return lowered.compile({"xla_backend_optimization_level": 0})(*args)


def run_jax(case):
    """Values of the JAX function and its input gradients (of
    ``sum(out[0] * ct)``), jitted with the case's other arguments as
    constants."""
    fn = getattr(jF, case.fn)
    args = [jnp.asarray(a) if isinstance(a, (np.ndarray, np.generic))
            else a for a in case.args]
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in case.kwargs.items()}

    def f(*g):
        a = list(args)
        for i, v in zip(case.grad, g):
            a[i] = v
        return _outs(fn(*a, **kw))
    if not case.grad:
        return [np.asarray(o) for o in f()], []
    primals = [args[i] for i in case.grad]
    shape = jax.eval_shape(lambda *g: f(*g)[0], *primals).shape
    ct = jnp.asarray(np.asarray(np.random.RandomState(99).randn(*shape),
                                np.float32))

    def both(*g):
        _, vjp = jax.vjp(lambda *g: f(*g)[0], *g)
        return f(*g), vjp(ct)
    outs, grads = _jit(both, *primals)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def run_torch(case, device="cpu", dtype=torch.float32):
    """Values of the port's function and its input gradients."""
    fn = getattr(tF, case.fn)

    def conv(a):
        if isinstance(a, (np.ndarray, np.generic)):
            t = torch.from_numpy(np.array(a)).to(device)
            return t.to(dtype) if t.is_floating_point() else t
        return a
    args = [conv(a) for a in case.args]
    for i in case.grad:
        args[i].requires_grad_()
    kw = {k: conv(v) if isinstance(v, np.ndarray) else v
          for k, v in case.kwargs.items()}
    outs = _outs(fn(*args, **kw))
    if case.grad:
        ct = np.asarray(np.random.RandomState(99).randn(*outs[0].shape))
        (outs[0] * torch.from_numpy(ct).to(device, outs[0].dtype)
         ).sum().backward()
    return ([o.detach().cpu().numpy() for o in outs],
            [args[i].grad.cpu().numpy() for i in case.grad])


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_function_matches_jax(case):
    jouts, jgrads = run_jax(case)
    touts, tgrads = run_torch(case)
    tol = _tol(case.name)
    assert len(touts) == len(jouts), case.name
    for i, (t, j) in enumerate(zip(touts, jouts)):
        _close(t, j, f"{case.name} output {i}", tol)
    for i, t, j in zip(case.grad, tgrads, jgrads):
        _close(t, j, f"{case.name} grad of input {i}", tol)


def test_the_table_covers_every_new_function():
    """Each name of ``nn.functional`` beyond the vision and Transformer
    ops has a case in the table or a test of its own below."""
    own = {"gumbel_softmax", "relu_", "elu_", "tanh_", "softmax_",
           "class_center_sample"}
    new = set(tF._ext_all) | {
        "elu", "mish", "softplus", "l1_loss",
        "binary_cross_entropy_with_logits", "smooth_l1_loss",
        "square_error_cost", "label_smooth",
        "softmax_mask_fuse_upper_triangle", "pad", "clip", "normalize",
        "interpolate", "pixel_shuffle", "pixel_unshuffle", "prelu", "glu",
        "cosine_similarity", "pairwise_distance", "conv3d",
        "conv2d_transpose", "max_pool1d", "avg_pool1d", "kl_div",
        "margin_ranking_loss", "hinge_embedding_loss",
        "cosine_embedding_loss", "triplet_margin_loss", "ctc_loss",
        "sparse_attention"}
    missing = new - own - {c.fn for c in CASES}
    assert not missing, sorted(missing)


def test_gelu_default_is_the_exact_form_bit_for_bit():
    x = torch.from_numpy(np.random.RandomState(3).randn(64).astype(
        np.float32) * 4)
    assert torch.equal(tF.gelu(x),
                       0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0))))
    from paddle_tpu_torch.nn import GELU
    assert torch.equal(GELU(approximate=True)(x),
                       tF.gelu(x, approximate=True))
    assert not torch.equal(tF.gelu(x, approximate=True), tF.gelu(x))


def test_ctc_gradient_is_not_the_library_one():
    """The port's gradient with respect to log_probs is JAX's (minus each
    cell's posterior); torch's library loss agrees in value only, and in
    gradient only through a log-softmax of logits."""
    case = next(c for c in CASES if c.name == "ctc_loss_sum")
    jouts, jgrads = run_jax(case)
    lp, labels, in_len, lab_len = [torch.from_numpy(a) for a in case.args]
    lp.requires_grad_()
    lib = torch.nn.functional.ctc_loss(lp, labels, in_len, lab_len,
                                       reduction="sum", zero_infinity=False)
    np.testing.assert_allclose(lib.item(), float(jouts[0]), rtol=1e-5)
    ct = np.random.RandomState(99).randn(*jouts[0].shape)
    (lib * float(ct)).backward()
    assert float(np.abs(lp.grad.numpy() - jgrads[0]).max()) > 1e-3


# ---------------------------------------------------------------------------
# In-place ops and the host-sampled class centers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kw", [("relu_", {}), ("elu_", {"alpha": 0.5}),
                                     ("tanh_", {}), ("softmax_",
                                                     {"axis": 0})])
def test_in_place_ops_overwrite_their_input(name, kw):
    a = np.random.RandomState(4).randn(3, 5).astype(np.float32)
    ref = np.asarray(getattr(jF, name)(jnp.asarray(a), **kw))
    x = torch.from_numpy(a.copy())
    y = getattr(tF, name)(x, **kw)
    assert y is x
    _close(x.numpy(), ref, name, TOL)


@pytest.mark.parametrize("num_samples", [4, 9])
def test_class_center_sample_equal_seeds_equal_samples(num_samples):
    label = np.asarray([3, 7, 3, 1, 9, 7])
    jr, js = jF.class_center_sample(jnp.asarray(label), 12, num_samples,
                                    seed=5)
    tr, ts = tF.class_center_sample(torch.from_numpy(label), 12,
                                    num_samples, seed=5)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert ts.dtype == torch.int64


# ---------------------------------------------------------------------------
# Random ops: statistics and structure
# ---------------------------------------------------------------------------
def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("fn,shape", [("dropout2d", (64, 64, 3, 2)),
                                      ("dropout3d", (64, 64, 2, 2, 2))])
def test_channel_dropout_zeroes_whole_channels(fn, shape):
    p = 0.3
    x = torch.rand(shape, generator=_gen(1)) + 0.5
    y = getattr(tF, fn)(x, p=p, generator=_gen(2))
    flat = y.reshape(shape[0], shape[1], -1)
    dropped = (flat == 0).all(dim=-1)
    kept = torch.isclose(flat, x.reshape_as(flat) / (1 - p)).all(dim=-1)
    assert bool((dropped | kept).all())
    rate = float(kept.float().mean())
    sigma = math.sqrt(p * (1 - p) / dropped.numel())
    assert abs(rate - (1 - p)) < 4 * sigma, rate
    # the device's stream when no generator is given, and eval is identity
    fw_random.seed(3)
    a = getattr(tF, fn)(x, p=p)
    fw_random.seed(3)
    assert torch.equal(a, getattr(tF, fn)(x, p=p))
    assert getattr(tF, fn)(x, p=p, training=False) is x


def test_alpha_dropout_moments_are_the_jax_formulas():
    """Dropped units are ``a (-alpha') + b`` at rate p; a standard input
    keeps mean 0 and gets the variance of the JAX op's ``a = (1 - p + p
    alpha'^2)^-1/2``, 1 - p^2 alpha'^2 a^2 (0.913 at p = 0.2: the
    correction omits the (1 - p) factor of the SELU paper's a)."""
    p = 0.2
    x = torch.randn(400_000, generator=_gen(5))
    y = tF.alpha_dropout(x, p=p, generator=_gen(6))
    neg = -1.6732632423543772 * 1.0507009873554805
    a = (1 - p + p * neg ** 2) ** -0.5
    dropped = torch.isclose(y, torch.tensor(a * neg - a * p * neg))
    assert abs(float(dropped.float().mean()) - p) < 0.005
    assert abs(float(y.mean())) < 0.01
    assert abs(float(y.var()) - (1 - (p * neg * a) ** 2)) < 0.01


def test_gumbel_softmax_samples_the_softmax():
    probs = np.asarray([0.6, 0.3, 0.1], np.float32)
    x = torch.from_numpy(np.log(probs)).expand(20000, 3).contiguous()
    y = tF.gumbel_softmax(x, hard=True, generator=_gen(7))
    onehot = torch.nn.functional.one_hot(y.argmax(-1), 3).float()
    # one-hot up to the rounding of onehot + y - stop_gradient(y)
    torch.testing.assert_close(y, onehot, rtol=0, atol=1e-6)
    freq = onehot.mean(0).numpy()
    np.testing.assert_allclose(freq, probs, atol=0.015)
    soft = tF.gumbel_softmax(x[:5], temperature=0.5, generator=_gen(8))
    np.testing.assert_allclose(soft.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_gumbel_softmax_hard_is_straight_through():
    x = torch.randn(4, 6, generator=_gen(9)).requires_grad_()
    ct = torch.randn(4, 6, generator=_gen(10))
    (tF.gumbel_softmax(x, hard=True, temperature=0.7, generator=_gen(11))
     * ct).sum().backward()
    hard_grad = x.grad.clone()
    x.grad = None
    (tF.gumbel_softmax(x, temperature=0.7, generator=_gen(11))
     * ct).sum().backward()
    torch.testing.assert_close(hard_grad, x.grad)
