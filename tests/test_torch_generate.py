"""Port parity for the ``generate`` slice: ``flash_attention_kvcache`` (the
plain version the CPU takes) against the JAX package's, whose Pallas decode
kernel runs in interpret mode on the CPU; and ``GPTForCausalLM.generate`` /
``generate_step`` / ``make_caches`` of both packages on the same numpy
weights and prompts, unfused with SDPA, unfused with
``use_pallas_attention`` and with ``use_fused_block``: greedy tokens
identical, step logits within a stated tolerance, EOS pinning and the early
stop token-exact; plus the port's own sampling checks."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.distributed as dist
from paddle_tpu.models.gpt import GPTConfig as JaxConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.ops import flash_attention_kvcache as jax_kvcache
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops.flash_attention import (flash_attention_kvcache,
                                                  flash_decode_reference)

pytestmark = pytest.mark.serving

# float32 on both sides with exact products (the suite pins JAX matmuls to
# "highest"): the two differ in summation order only, ~1e-7 on logits of
# magnitude ~1 through two layers; 1e-5 is the bound
LOGITS_ATOL = 1e-5
# the decode op in float32, as the JAX package's own TestFlashKVCache holds
# its kernel against attention over the cache prefix
OP_TOL = 2e-4
PROMPT = (2, 8)
NEW = 8
CONFIGS = {
    "sdpa": dict(),
    "pallas": dict(use_pallas_attention=True),
    "fused": dict(use_fused_block=True),
}


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
    # the JAX decode kernel route is mesh-gated; earlier files in a full run
    # may leave a hybrid mesh installed
    dist.set_hybrid_communicate_group(None)
    yield
    dist.set_hybrid_communicate_group(None)


def _cfg_kw(**kw):
    return dict(hidden_size=64, num_layers=2, num_heads=4,
                max_position_embeddings=64, vocab_size=256,
                hidden_dropout=0.0, attention_dropout=0.0, **kw)


def _state(kw, seed=0):
    """Seeded numpy weights in the JAX layout: LN gains near 1, everything
    else small normal."""
    shapes = {k: v.shape for k, v in
              JaxGPT(JaxConfig(**_cfg_kw(**kw))).state_dict().items()}
    rng = np.random.RandomState(seed)
    out = {}
    for k in sorted(shapes):
        a = rng.randn(*shapes[k]).astype(np.float32)
        gain = k.endswith(("ln_1.weight", "ln_2.weight", "ln_f.weight"))
        out[k] = (1.0 + 0.1 * a) if gain else 0.1 * a
    return out


def _port(kw, state):
    return load_jax_state(GPTForCausalLM(GPTConfig(**_cfg_kw(**kw)),
                                         device="cpu"), state)


@pytest.fixture(scope="module")
def models():
    """(jax model, port model, numpy state) per configuration, built once:
    the JAX package caches its jitted step on the instance."""
    built = {}

    def get(name):
        if name not in built:
            kw = CONFIGS[name]
            state = _state(kw)
            jm = JaxGPT(JaxConfig(**_cfg_kw(**kw)))
            jm.set_state_dict({k: jnp.asarray(v) for k, v in state.items()})
            built[name] = (jm, _port(kw, state), state)
        return built[name]
    return get


def _prompt(seed=1):
    return np.random.RandomState(seed).randint(0, 256, PROMPT).astype(
        np.int32)


# -- (a) the decode op ---------------------------------------------------------
def _kv_inputs(sq, cache_dtype, seed=3):
    r = np.random.RandomState(seed)
    q = (r.randn(2, 2, sq, 16) * 0.5).astype(np.float32)
    kc = (r.randn(2, 2, 128, 16) * 0.5).astype(np.float32)
    vc = (r.randn(2, 2, 128, 16) * 0.5).astype(np.float32)
    jax_out = lambda n: np.asarray(jax_kvcache(  # noqa: E731
        jnp.asarray(q), jnp.asarray(kc, cache_dtype),
        jnp.asarray(vc, cache_dtype), n))
    tdt = torch.float32 if cache_dtype == jnp.float32 else torch.bfloat16
    tq = torch.from_numpy(q)
    tk, tv = (torch.from_numpy(a).to(tdt) for a in (kc, vc))
    return jax_out, tq, tk, tv


@pytest.mark.parametrize("sq", [1, 2])
def test_kvcache_op_matches_pallas_f32(sq):
    jax_out, q, k, v = _kv_inputs(sq, jnp.float32)
    out = flash_attention_kvcache(q, k, v, 77)
    assert out.dtype == torch.float32 and out.shape == (2, 2, sq, 16)
    np.testing.assert_allclose(out.numpy(), jax_out(77), rtol=OP_TOL,
                               atol=OP_TOL)


@pytest.mark.parametrize("sq", [1, 2])
def test_kvcache_op_f32_query_over_bf16_cache(sq):
    """float32 q over a bf16 cache, as the fused decode hands it over.  Both
    round p to bf16 before P.V against the same max (one 128-wide block);
    a p next to a rounding boundary may round one bf16 unit (2^-8
    relative) apart, so element (b, h, i, e) may move by 2^-8 times the
    same attention over |v|, plus 1e-5 for float32 sums in another order."""
    jax_out, q, k, v = _kv_inputs(sq, jnp.bfloat16)
    out = flash_attention_kvcache(q, k, v, 77)
    assert out.dtype == torch.float32
    bound = flash_decode_reference(q, k, v.float().abs(), 77)
    tol = bound.numpy() * 2.0 ** -8 + 1e-5
    assert (np.abs(out.numpy() - jax_out(77)) <= tol).all()


def test_kvcache_op_length_zero_and_tensor_length():
    jax_out, q, k, v = _kv_inputs(1, jnp.float32)
    assert float(flash_attention_kvcache(q, k, v, 0).abs().max()) == 0.0
    assert float(np.abs(jax_out(0)).max()) == 0.0
    as_int = flash_attention_kvcache(q, k, v, 77)
    as_tensor = flash_attention_kvcache(
        q, k, v, torch.tensor(77, dtype=torch.int32))
    assert torch.equal(as_int, as_tensor)
    # lengths past the capacity clamp to it
    assert torch.equal(flash_attention_kvcache(q, k, v, 500),
                       flash_attention_kvcache(q, k, v, 128))


def test_kvcache_op_capacity_must_be_padded():
    q = torch.zeros(1, 1, 1, 16)
    k = torch.zeros(1, 1, 12, 16)
    with pytest.raises(Exception, match="multiple of 8"):
        flash_attention_kvcache(q, k, k, 4)


# -- (b) generate and generate_step against JAX --------------------------------
@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_generate_matches_jax(models, name):
    jm, tm, _ = models(name)
    prompt = _prompt()
    want = np.asarray(jm.generate(jnp.asarray(prompt), max_new_tokens=NEW,
                                  temperature=0.0))
    got = tm.generate(prompt, max_new_tokens=NEW)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_logits_match_jax(models, name, monkeypatch):
    """Prefill, then the first single-token step (the decode kernel's
    route with ``use_pallas_attention``, taken on both sides), with the
    position offset as a tensor on the port's side."""
    import paddle_tpu.ops as jax_ops
    import paddle_tpu_torch.models.gpt as port_gpt
    calls = {"jax": 0, "port": 0}

    def counted(mod, attr, key):
        fn = getattr(mod, attr)

        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, attr, wrapper)
    counted(jax_ops, "flash_attention_kvcache", "jax")
    counted(port_gpt, "flash_attention_kvcache", "port")
    jm, tm, _ = models(name)
    prompt = _prompt()
    cap = PROMPT[1] + NEW
    jc = jm.make_caches(PROMPT[0], cap)
    tc = tm.make_caches(PROMPT[0], cap)
    jl, jc = jm.generate_step(jnp.asarray(prompt), jc, 0)
    tl, tc = tm.generate_step(torch.from_numpy(prompt), tc, 0)
    assert tuple(tl.shape) == (PROMPT[0], 1, 256)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGITS_ATOL)
    nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    assert [int(u) for _, _, u in tc] == [PROMPT[1]] * 2
    jl2, _ = jm.generate_step(jnp.asarray(nxt), jc, PROMPT[1])
    tl2, tc2 = tm.generate_step(torch.from_numpy(nxt), tc,
                                torch.tensor(PROMPT[1], dtype=torch.int32))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=0,
                               atol=LOGITS_ATOL)
    assert [int(u) for _, _, u in tc2] == [PROMPT[1] + 1] * 2
    # one decode-op call per layer in the single-token step, none in prefill
    want = 2 if name == "pallas" else 0
    assert calls == {"jax": want, "port": want}


# -- (c) greedy against re-decoding with the full forward ----------------------
@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_matches_full_recompute(models, name):
    _, tm, state = models(name)
    # the cache-free forward has no fused-block path yet: re-decode with
    # the unfused model on the same weights
    full = _port({}, state) if name == "fused" else tm
    prompt = _prompt(2)
    out = tm.generate(prompt, max_new_tokens=NEW)
    ids = torch.from_numpy(prompt).long()
    with torch.no_grad():
        for _ in range(NEW):
            nxt = full(ids)[:, -1].float().argmax(-1)
            ids = torch.cat([ids, nxt[:, None]], dim=1)
    assert torch.equal(out.long(), ids)


# -- (d) EOS pinning and the early stop -----------------------------------------
@pytest.mark.parametrize("name", ["pallas", "fused"])
def test_eos_pinning_and_early_stop_match_jax(models, name):
    jm, tm, _ = models(name)
    prompt = _prompt()
    free = tm.generate(prompt, max_new_tokens=NEW).numpy()
    eos = int(free[0, PROMPT[1] + 2])
    got = tm.generate(prompt, max_new_tokens=NEW, eos_token_id=eos)
    want = jm.generate(jnp.asarray(prompt), max_new_tokens=NEW,
                       eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    row = got.numpy()[0, PROMPT[1]:]
    first = int(np.argmax(row == eos))
    assert (row[first:] == eos).all()
    # one row: it stops at its first EOS
    got1 = tm.generate(prompt[:1], max_new_tokens=NEW, eos_token_id=eos)
    want1 = jm.generate(jnp.asarray(prompt[:1]), max_new_tokens=NEW,
                        eos_token_id=eos)
    np.testing.assert_array_equal(got1.numpy(), np.asarray(want1))
    assert got1.shape[1] == PROMPT[1] + first + 1 < PROMPT[1] + NEW


# -- (e) sampling ----------------------------------------------------------------
def test_sampling_is_seeded_and_top_k_bounded(models):
    _, tm, _ = models("sdpa")
    prompt = _prompt()
    run = lambda **kw: tm.generate(prompt, max_new_tokens=NEW,  # noqa: E731
                                   temperature=0.9, **kw)
    a, b, c = run(top_k=5, seed=11), run(top_k=5, seed=11), run(top_k=5,
                                                                   seed=12)
    assert torch.equal(a, b) and not torch.equal(a, c)
    g = torch.Generator().manual_seed(3)
    h = torch.Generator().manual_seed(3)
    assert torch.equal(run(generator=g), run(generator=h))
    greedy = tm.generate(prompt, max_new_tokens=NEW)
    assert torch.equal(run(top_k=1, seed=4), greedy)
    # every sampled token is among the 5 largest logits of its step (the
    # full forward's logits, within its 1e-5 of the step's)
    with torch.no_grad():
        logits = tm(a[:, :-1].long())
    for t in range(PROMPT[1], PROMPT[1] + NEW):
        step = logits[:, t - 1]
        kth = torch.topk(step, 5, dim=-1).values[:, -1]
        chosen = step.gather(1, a[:, t].long()[:, None])[:, 0]
        assert bool((chosen >= kth - 1e-5).all())


# -- (f) the caches ---------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_caches_match_jax(dtype):
    kw = dict(dtype=dtype)
    jm = JaxGPT(JaxConfig(**_cfg_kw(**kw)))
    tm = GPTForCausalLM(GPTConfig(**_cfg_kw(**kw)), device="cpu")
    jc, tc = jm.make_caches(3, 24), tm.make_caches(3, 24)
    assert len(jc) == len(tc) == 2
    for (jk, jv, ju), (tk, tv, tu) in zip(jc, tc):
        for j, t in ((jk, tk), (jv, tv)):
            assert tuple(t.shape) == tuple(j.shape) == (3, 4, 24, 16)
            assert str(t.dtype).split(".")[-1] == str(j.dtype)
            assert float(t.abs().max()) == 0.0
        assert tu.shape == () and tu.dtype == torch.int32
        assert int(tu) == int(ju) == 0 and str(ju.dtype) == "int32"


def test_step_past_the_cache_capacity_raises(models):
    """A direct ``generate_step`` whose ``used + s`` exceeds the cache
    capacity: the JAX package clamps the write start
    (``lax.dynamic_update_slice`` keeps the update inside the buffer, so the
    chunk overwrites the last positions), while the port's ``index_copy_``
    raises on the out-of-range rows: the port keeps the safer behaviour, and
    the caller's position count is not advanced."""
    jm, tm, _ = models("sdpa")
    prompt = _prompt()
    cap = PROMPT[1] + 2
    jc = jm.make_caches(PROMPT[0], cap)
    tc = tm.make_caches(PROMPT[0], cap)
    _, jc = jm.generate_step(jnp.asarray(prompt), jc, 0)
    _, tc = tm.generate_step(torch.from_numpy(prompt), tc, 0)
    chunk = prompt[:, :3]                       # used 8 + 3 > capacity 10
    jl, jc2 = jm.generate_step(jnp.asarray(chunk), jc, PROMPT[1])
    assert np.isfinite(np.asarray(jl)).all()
    assert [int(u) for _, _, u in jc2] == [PROMPT[1] + 3] * 2
    with pytest.raises(IndexError, match="out of bounds"):
        tm.generate_step(torch.from_numpy(chunk), tc,
                         torch.tensor(PROMPT[1], dtype=torch.int32))
    assert [int(u) for _, _, u in tc] == [PROMPT[1]] * 2


def test_generate_guards():
    tm = GPTForCausalLM(GPTConfig(**_cfg_kw()), device="cpu")
    prompt = _prompt()
    assert torch.equal(tm.generate(prompt, max_new_tokens=0),
                       torch.from_numpy(prompt))
    with pytest.raises(Exception, match="max_position_embeddings"):
        tm.generate(prompt, max_new_tokens=60)
    # the model keeps the decode loop of its last (batch, capacity,
    # temperature, top_k) only
    tm.generate(prompt, max_new_tokens=4)
    tm.generate(prompt[:1], max_new_tokens=4)
    assert tm._gen_loop.key == (1, PROMPT[1] + 4, 0.0, 0)


def test_dropping_the_model_frees_its_decode_loop():
    # the model owns its decode loop and the loop keeps no reference back:
    # with no cycle, deleting the model frees its caches at once
    import weakref
    tm = GPTForCausalLM(GPTConfig(**_cfg_kw()), device="cpu")
    tm.generate(_prompt(), max_new_tokens=4)
    model, caches = weakref.ref(tm), weakref.ref(tm._gen_loop.caches[0][0])
    del tm
    assert model() is None and caches() is None
