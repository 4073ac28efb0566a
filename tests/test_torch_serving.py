"""Port parity for the serving slice as a whole: one ServingEngine of each
package, on the same numpy weights and prompts, on the CPU — greedy tokens
identical and logits within a stated tolerance, with ``use_fused_block``
on and off and with preemption forced; plus the port's own allocator,
scheduler, sampling and device-resolution checks."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.distributed as dist
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch import UnavailableError
from paddle_tpu_torch.convert import load_jax_state, state_dict_from_jax
from paddle_tpu_torch.inference import BlockAllocator, ServingEngine
from paddle_tpu_torch.inference.scheduler import prefill_bucket
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny

pytestmark = pytest.mark.serving

# float32 end to end on both sides with exact products: the logits differ
# only by summation order through two layers, ~1e-7; 1e-4 is the bound
LOGITS_ATOL = 1e-4
PROMPT_LENS = (5, 12, 3, 9)
MAX_NEW = 6


@pytest.fixture(autouse=True)
def _no_mesh():
    # the JAX engine refuses to run under a hybrid mesh; earlier files in a
    # full run may leave one installed
    dist.set_hybrid_communicate_group(None)
    yield
    dist.set_hybrid_communicate_group(None)


def _state(cfg_kw, seed=0):
    """A JAX model's state_dict keys and shapes, filled with seeded numpy
    weights (LN gains near 1, everything else small normal)."""
    shapes = {k: v.shape for k, v in
              JaxGPT(jax_gpt_tiny(**cfg_kw)).state_dict().items()}
    rng = np.random.RandomState(seed)
    out = {}
    for k in sorted(shapes):
        a = rng.randn(*shapes[k]).astype(np.float32)
        gain = k.endswith(("ln_1.weight", "ln_2.weight", "ln_f.weight"))
        out[k] = (1.0 + 0.1 * a) if gain else 0.1 * a
    return out


def _models(fused, dtype="float32", seed=0):
    kw = dict(hidden_dropout=0.0, attention_dropout=0.0,
              use_fused_block=fused, dtype=dtype)
    state = _state(kw, seed)
    jm = JaxGPT(jax_gpt_tiny(**kw))
    jm.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
    tm = load_jax_state(GPTForCausalLM(gpt_tiny(**kw), device="cpu"), state)
    return jm, tm


def _prompts(seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, n).tolist() for n in PROMPT_LENS]


def _serve(engine, prompts):
    rids = [engine.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    engine.run(max_steps=500)
    return [engine.collect(r) for r in rids]


def _engines(jm, tm, **kw):
    kw = dict(max_seqs=4, kv_block_size=4, max_model_len=64,
              capture_logits=True, **kw)
    return JaxEngine(jm, **kw), ServingEngine(tm, **kw)


@pytest.mark.parametrize("fused", [False, True])
def test_tokens_and_logits_match_jax(fused):
    jm, tm = _models(fused)
    je, te = _engines(jm, tm)
    prompts = _prompts()
    for a, b in zip(_serve(je, prompts), _serve(te, prompts)):
        assert a["tokens"] == b["tokens"]
        assert len(b["tokens"]) == MAX_NEW
        np.testing.assert_allclose(b["logits"][0], a["logits"][0],
                                   atol=LOGITS_ATOL)
        np.testing.assert_allclose(np.stack(b["logits"]),
                                   np.stack(a["logits"]), atol=LOGITS_ATOL)
    assert te.cache.leak_report()["leaked_blocks"] == 0


@pytest.mark.parametrize("fused", [False, True])
def test_preemption_recompute_matches_jax(fused):
    # 8 blocks of 4 slots cannot hold all four sequences to the end (15
    # blocks), so decode preempts newest-first and re-prefills
    jm, tm = _models(fused, seed=2)
    je, te = _engines(jm, tm, num_kv_blocks=8)
    prompts = _prompts(seed=3)
    got = _serve(te, prompts)
    ref = _serve(je, prompts)
    assert te.sched.preemptions > 0
    assert te.sched.preemptions == je.sched.preemptions
    for a, b in zip(ref, got):
        assert a["tokens"] == b["tokens"]
    # the tight run is token-exact against a roomy one too
    _, roomy = _engines(jm, tm)
    for a, b in zip(_serve(roomy, prompts), got):
        assert a["tokens"] == b["tokens"]
    report = te.cache.leak_report()
    assert report["leaked_blocks"] == 0 and report["num_used"] == 0
    assert report["balanced"]


def test_bf16_serving_logits_close_to_jax():
    # the serving dtype flow (bf16 residual and pages, float32 parameters):
    # both sides round the same intermediates to bf16, but a float32 value
    # on a rounding boundary may round differently after a reordered sum,
    # and one bf16 ulp (2^-8 relative) can spread through the layers;
    # 5e-2 of the logits' range is far below what a wrong op gives
    jm, tm = _models(True, dtype="bfloat16", seed=4)
    je, te = _engines(jm, tm)
    prompts = _prompts(seed=5)
    for a, b in zip(_serve(je, prompts), _serve(te, prompts)):
        ref, got = np.asarray(a["logits"][0]), np.asarray(b["logits"][0])
        assert np.isfinite(got).all() and got.shape == (1024,)
        assert np.abs(got - ref).max() <= 5e-2 * np.abs(ref).max()
    assert te.cache.pages[0][0].dtype == torch.bfloat16


def test_sampling_is_seeded():
    _, tm = _models(False)
    outs = []
    for seed in (11, 11, 12):
        eng = ServingEngine(tm, max_seqs=4, kv_block_size=4,
                            max_model_len=64, temperature=0.8, seed=seed)
        outs.append(eng.generate(_prompts(), max_new_tokens=MAX_NEW))
    assert outs[0] == outs[1]
    assert outs[0] != outs[2]
    assert all(0 <= t < 1024 for row in outs[0] for t in row)


def test_collect_record_and_stats():
    _, tm = _models(True)
    eng = ServingEngine(tm, max_seqs=4, kv_block_size=4, max_model_len=64)
    rid = eng.submit(_prompts()[0], max_new_tokens=3, request_id="r0")
    rec = eng.collect(rid)
    assert rec["request_id"] == "r0" and len(rec["tokens"]) == 3
    assert rec["finish_reason"] == "max_new_tokens"
    assert rec["ttft_ms"] >= 0 and rec["tpot_ms"] >= 0
    st = eng.stats()
    assert st["finished"] == 1 and st["kv_blocks"]["used"] == 0
    assert st["step_ms"]["prefill"]["count"] == 1
    assert st["step_ms"]["decode"]["count"] == 2


def test_eos_stops_early():
    _, tm = _models(False)
    eng = ServingEngine(tm, max_seqs=4, kv_block_size=4, max_model_len=64)
    first = eng.generate([_prompts()[1]], max_new_tokens=MAX_NEW)[0]
    eng2 = ServingEngine(tm, max_seqs=4, kv_block_size=4, max_model_len=64)
    rid = eng2.submit(_prompts()[1], max_new_tokens=MAX_NEW,
                      eos_token_id=first[1])
    rec = eng2.collect(rid)
    assert rec["tokens"] == first[:2] and rec["finish_reason"] == "eos"


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UnavailableError, match="no CUDA device"):
        GPTForCausalLM(gpt_tiny())
    with pytest.raises(UnavailableError):
        GPTForCausalLM(gpt_tiny(), device="cuda")


def test_state_dict_keys_match_jax():
    kw = dict(hidden_dropout=0.0, attention_dropout=0.0)
    state = _state(kw)
    tm = GPTForCausalLM(gpt_tiny(**kw), device="cpu")
    assert set(tm.state_dict()) == set(state)
    converted = state_dict_from_jax(state)
    for k, v in state.items():
        assert converted[k].dtype == torch.float32
        np.testing.assert_array_equal(converted[k].numpy(), v)
    with pytest.raises(ValueError, match="missing"):
        load_jax_state(tm, {k: v for k, v in state.items()
                            if k != "gpt.wpe"})


def test_block_allocator_ledger():
    a = BlockAllocator(4, block_size=8)
    g1 = a.alloc(3)
    assert sorted(g1) == [0, 1, 2] and a.num_free == 1
    assert a.alloc(2) is None and a.num_free == 1     # all-or-nothing
    a.free(g1[:2])
    assert a.alloc(3) is not None and a.num_free == 0
    with pytest.raises(ValueError, match="double"):
        a.free([g1[0], g1[0]])
    assert a.stats()["high_water"] == 4


def test_prefill_buckets():
    assert [prefill_bucket(n, 64) for n in (1, 8, 9, 33, 64)] \
        == [8, 8, 16, 64, 64]
    with pytest.raises(ValueError):
        prefill_bucket(65, 64)
