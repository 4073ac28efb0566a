"""Port parity of activation recompute (``use_recompute``,
``recompute_policy``; ``distributed/fleet/recompute.py``), on the CPU:

- ``gpt_tiny`` with ``use_recompute=True`` under every policy, unfused and
  fused, at dropout 0: the loss and every gradient against the JAX model
  with the same config (``jax.checkpoint`` with the same policy);
- with dropout > 0 (the flash ops' and the fused ops' hash seeds, the
  unfused dropout masks), and under O1, the port's recompute gradients
  equal its no-recompute gradients bit for bit: the replay restores the
  framework's random streams and the amp policy; and the streams stand
  after the step where a step without recompute leaves them;
- what each policy keeps: the matrix products the backward replays,
  ordered full > no-batch dots > dots = everything = no recompute;
- the functional ``recompute`` / ``recompute_wrapper`` and the refusal of
  an unknown policy.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax

import paddle_tpu.distributed as dist
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.distributed.fleet.recompute import (recompute,
                                                          recompute_wrapper)
from paddle_tpu_torch.framework import random as fw_random
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.nn import functional as F

B, S = 2, 64
# float32 on both sides with exact products (the suite pins JAX matmuls to
# "highest"): summation order only, as tests/test_torch_training.py bounds
# it: 1e-4 of each tensor's range plus 1e-7 for rounding-noise tensors
F32_TOL = 1e-4
POLICIES = [None, "full", "dots_saveable", "dots_with_no_batch_dims_saveable",
            "everything_saveable"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's torch work: under the suite's
    six xdist workers, eight OpenMP threads a worker oversubscribe the
    eight cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_mesh():
    # the JAX fused block runs only without a mesh
    dist.set_hybrid_communicate_group(None)
    yield
    dist.set_hybrid_communicate_group(None)


def _close(got, ref, what, tol=F32_TOL):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    bound = tol * float(np.abs(ref).max()) + 1e-7
    assert err <= bound, f"{what}: max |port - jax| {err:.3e} > {bound:.3e}"


def _weights(jm, seed=0):
    r = np.random.RandomState(seed)
    state = {}
    for k, v in sorted(jm.state_dict().items()):
        a = r.randn(*v.shape).astype(np.float32)
        gain = k.endswith(("ln_1.weight", "ln_2.weight", "ln_f.weight"))
        state[k] = (1.0 + 0.1 * a) if gain else 0.1 * a
    return state


def _data(seed=1):
    r = np.random.RandomState(seed)
    return (r.randint(0, 1024, (B, S)).astype(np.int32),
            r.randint(0, 1024, (B, S)).astype(np.int32))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_recompute_grads_match_jax(fused, policy):
    kw = dict(hidden_dropout=0.0, attention_dropout=0.0,
              use_fused_block=fused, use_recompute=True,
              recompute_policy=policy, max_position_embeddings=S)
    jm = JaxGPT(jax_gpt_tiny(**kw))
    jm.train()
    state = _weights(jm)
    jm.set_state_dict({k: jax.numpy.asarray(v) for k, v in state.items()})
    ids, labels = _data()

    def loss_fn(p):
        loss, _ = jm.apply(p, jax.numpy.asarray(ids),
                           labels=jax.numpy.asarray(labels))
        return loss
    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(jm.state_dict())

    tm = load_jax_state(GPTForCausalLM(gpt_tiny(**kw), device="cpu"), state)
    tm.train()
    tl, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    tl.backward()
    _close(tl.detach(), jl, "loss")
    grads = dict(tm.named_parameters())
    assert set(grads) == set(jg)
    for k in sorted(jg):
        _close(grads[k].grad, jg[k], f"grad {k}")


def _port_grads(cfg, ids, labels, seed=7, o1=False):
    torch.manual_seed(0)
    m = GPTForCausalLM(cfg, device="cpu")
    m.train()
    fw_random.seed(seed)
    with tamp.auto_cast(enable=o1, level="O1", dtype="bfloat16"):
        loss, _ = m(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    after = fw_random.get_state()
    return loss.detach(), {n: p.grad for n, p in m.named_parameters()}, after


CASES = {
    # (use_fused_block, use_pallas_attention, dtype, O1)
    "unfused-flash": (False, True, "float32", False),
    "unfused-sdpa": (False, False, "float32", False),
    "fused": (True, True, "float32", False),
    "unfused-flash-o1": (False, True, "bfloat16", True),
    "fused-o1": (True, True, "bfloat16", True),
}


@pytest.mark.parametrize("policy", ["full", "dots_saveable"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dropout_recompute_grads_equal_no_recompute_bit_for_bit(case,
                                                                policy):
    fused, pallas, dtype, o1 = CASES[case]
    ids, labels = _data(2)
    runs = []
    for rc in (False, True):
        cfg = gpt_tiny(hidden_dropout=0.1, attention_dropout=0.1,
                       use_fused_block=fused, use_pallas_attention=pallas,
                       dtype=dtype, use_recompute=rc, recompute_policy=policy,
                       max_position_embeddings=S)
        runs.append(_port_grads(cfg, ids, labels, o1=o1))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    # the replay put the streams back: they stand where the plain step
    # left them
    assert set(s0) == set(s1)
    for dev in s0:
        assert torch.equal(s0[dev], s1[dev]), dev


def test_another_seed_gives_other_grads():
    # the bit-for-bit test above is not vacuous: the masks move the grads
    ids, labels = _data(2)
    cfg = gpt_tiny(hidden_dropout=0.1, attention_dropout=0.1,
                   use_pallas_attention=True, use_recompute=True,
                   max_position_embeddings=S)
    _, g0, _ = _port_grads(cfg, ids, labels, seed=7)
    _, g1, _ = _port_grads(cfg, ids, labels, seed=8)
    assert not torch.equal(g0["gpt.wte.weight"], g1["gpt.wte.weight"])


class _CountProducts(TorchDispatchMode):
    """Counts the matrix products that run under it."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            self.count += 1
        return func(*args, **(kwargs or {}))


def _backward_products(cfg, ids, labels):
    """Matrix products run by the backward: its own, plus those of the
    forward that the replay recomputes rather than takes from the saved
    results."""
    torch.manual_seed(0)
    m = GPTForCausalLM(cfg, device="cpu")
    m.train()
    loss, _ = m(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    with _CountProducts() as mode:
        loss.backward()
    return mode.count


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_policies_order_what_is_recomputed(fused):
    ids, labels = _data(3)
    n = {}
    for policy in [*POLICIES, "none"]:
        cfg = gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0,
                       use_fused_block=fused, use_pallas_attention=True,
                       use_recompute=policy != "none",
                       recompute_policy=None if policy == "none" else policy,
                       max_position_embeddings=S)
        n[policy] = _backward_products(cfg, ids, labels)
    # full replays every product; without batch dims keeps the linear
    # layers' (mm) and replays the attention's (bmm); dots and everything
    # keep them all, as no recompute does
    assert n[None] == n["full"]
    assert n["full"] > n["dots_with_no_batch_dims_saveable"] > \
        n["dots_saveable"]
    assert n["dots_saveable"] == n["everything_saveable"] == n["none"]


def test_recompute_function_and_wrapper():
    x = torch.randn(8, 16, requires_grad=True)
    w = torch.randn(16, 16, requires_grad=True)

    def block(x):
        return F.dropout(torch.tanh(x @ w), 0.5)

    fw_random.seed(3)
    ref = block(x)
    ref.sum().backward()
    gx, gw = x.grad.clone(), w.grad.clone()
    for fn in (lambda x: recompute(block, x, policy="dots_saveable"),
               recompute_wrapper(block)):
        x.grad = w.grad = None
        fw_random.seed(3)
        out = fn(x)
        out.sum().backward()
        assert torch.equal(out, ref)
        assert torch.equal(x.grad, gx) and torch.equal(w.grad, gw)


def test_recompute_config_is_accepted_and_unknown_policy_raises():
    cfg = gpt_tiny(use_recompute=True, recompute_policy="dots_saveable")
    assert cfg.use_recompute and cfg.recompute_policy == "dots_saveable"
    # the JAX package reads an unknown policy as "full"; the port refuses it
    with pytest.raises(ValueError, match="recompute_policy"):
        gpt_tiny(use_recompute=True, recompute_policy="dots")
    with pytest.raises(ValueError, match="recompute policy"):
        recompute(lambda x: x, torch.ones(2), policy="everything")
