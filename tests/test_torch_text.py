"""Port parity of the WMT datasets (``paddle_tpu_torch/text/datasets.py``)
and of beam-search decoding (``nn.functional.gather_tree``,
``nn.BeamSearchDecoder``, ``nn.dynamic_decode``) against the JAX package on
the CPU.  Dataset items and dictionaries must be identical, beam-search ids
exact, log-probabilities within 1e-6 (relative, and absolute near 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as jF
from paddle_tpu.text import WMT14 as JWMT14
from paddle_tpu.text import WMT16 as JWMT16
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.text import WMT14, WMT16


def _same_items(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        for x, y in zip(a[i], b[i]):
            assert x.dtype == y.dtype == np.int64
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mode", ["train", "test", "gen"])
@pytest.mark.parametrize("dict_size", [64, 30000])
def test_wmt14_items_and_dicts_match_jax(mode, dict_size):
    _same_items(WMT14(mode=mode, dict_size=dict_size, synthetic_size=40),
                JWMT14(mode=mode, dict_size=dict_size, synthetic_size=40))
    t = WMT14(mode=mode, dict_size=dict_size, synthetic_size=1)
    j = JWMT14(mode=mode, dict_size=dict_size, synthetic_size=1)
    for reverse in (False, True):
        assert t.get_dict(reverse) == j.get_dict(reverse)


def test_wmt14_default_sizes_match_jax():
    for mode, n in (("test", 512), ("gen", 128)):
        t, j = WMT14(mode=mode, dict_size=100), JWMT14(mode=mode,
                                                       dict_size=100)
        assert len(t) == n
        _same_items(t, j)


@pytest.mark.parametrize("mode", ["train", "test", "val"])
@pytest.mark.parametrize("lang", ["en", "de"])
def test_wmt16_items_and_dicts_match_jax(mode, lang):
    kw = dict(mode=mode, src_dict_size=50, trg_dict_size=70, lang=lang,
              synthetic_size=40)
    t, j = WMT16(**kw), JWMT16(**kw)
    _same_items(t, j)
    for d in ("en", "de"):
        for reverse in (False, True):
            assert t.get_dict(d, reverse) == j.get_dict(d, reverse)


def test_wmt_refusals_match_jax():
    for make in (lambda M: M(data_file="x.tgz"),
                 lambda M: M(mode="dev"),
                 lambda M: M(dict_size=3, synthetic_size=2)):
        with pytest.raises(Exception):
            make(JWMT14)
        with pytest.raises(Exception):
            make(WMT14)
    with pytest.raises(Exception):
        WMT16(src_dict_size=-1, trg_dict_size=10)


def test_wmt_target_is_the_source_permuted():
    d = WMT14(mode="train", dict_size=40, synthetic_size=200)
    seen = {}
    for src, tin, tnx in (d[i] for i in range(len(d))):
        assert tin[0] == 0 and tnx[-1] == 1
        np.testing.assert_array_equal(tin[1:], tnx[:-1])
        for s, t in zip(src, tnx[:-1]):
            assert seen.setdefault(int(s), int(t)) == int(t)


# ---------------------------------------------------------------------------
# gather_tree and beam search
# ---------------------------------------------------------------------------
def test_gather_tree_matches_jax():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 9, (6, 3, 4)).astype(np.int32)
    parents = rng.randint(0, 4, (6, 3, 4)).astype(np.int32)
    ref = jF.gather_tree(jnp.asarray(ids), jnp.asarray(parents))
    got = tF.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


V, HID = 7, 16


def _cell_weights():
    rng = np.random.RandomState(1)
    return (rng.randn(V, HID).astype(np.float32),
            (rng.randn(HID, HID) * 0.5).astype(np.float32),
            (rng.randn(HID, V) * 1.5).astype(np.float32))


def _jax_cell():
    emb, w, u = map(jnp.asarray, _cell_weights())

    def cell(tok, state):
        h = jnp.tanh(emb[tok] + state["h"] @ w)
        return h @ u, {"h": h, "src": state["src"]}
    return cell


def _port_cell():
    emb, w, u = map(torch.from_numpy, _cell_weights())

    def cell(tok, state):
        h = torch.tanh(emb[tok.long()] + state["h"] @ w)
        return h @ u, {"h": h, "src": state["src"]}
    return cell


def _inits(b=3):
    rng = np.random.RandomState(2)
    return (rng.randn(b, HID).astype(np.float32),
            rng.randint(0, 5, (b, 4)).astype(np.int32))


def test_beam_search_steps_match_jax():
    h0, src = _inits()
    jd = jnn.BeamSearchDecoder(_jax_cell(), start_token=0, end_token=1,
                               beam_size=3)
    td = tnn.BeamSearchDecoder(_port_cell(), start_token=0, end_token=1,
                               beam_size=3)
    jstate = jd.initialize({"h": jnp.asarray(h0), "src": jnp.asarray(src)},
                           3)
    tstate = td.initialize({"h": torch.from_numpy(h0),
                            "src": torch.from_numpy(src)}, 3)
    assert tuple(tstate[3]["h"].shape) == (9, HID)
    np.testing.assert_array_equal(tstate[3]["src"].numpy(),
                                  np.asarray(jstate[3]["src"]))
    finished_any = False
    for step in range(6):
        jout = jd.step(*jstate)
        tout = td.step(*tstate)
        for name, a, b in zip(("tokens", "finished", "parent"),
                              (tout[0], tout[2], tout[4]),
                              (jout[0], jout[2], jout[4])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{name} at {step}")
        np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tout[3]["h"].numpy(),
                                   np.asarray(jout[3]["h"]), rtol=1e-6,
                                   atol=1e-6)
        finished_any |= bool(tout[2].any())
        jstate, tstate = jout[:4], tout[:4]
    assert finished_any


def test_dynamic_decode_matches_jax():
    h0, src = _inits()
    jd = jnn.BeamSearchDecoder(_jax_cell(), start_token=0, end_token=1,
                               beam_size=3)
    td = tnn.BeamSearchDecoder(_port_cell(), start_token=0, end_token=1,
                               beam_size=3)
    jids, jlp = jnn.dynamic_decode(
        jd, inits={"h": jnp.asarray(h0), "src": jnp.asarray(src)},
        max_step_num=9)
    tids, tlp = tnn.dynamic_decode(
        td, inits={"h": torch.from_numpy(h0), "src": torch.from_numpy(src)},
        max_step_num=9)
    assert tids.shape == (3, 3, jids.shape[2])
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-6,
                               atol=1e-6)


def test_tile_beam_merge_with_batch_matches_jax():
    x = np.arange(6).reshape(3, 2)
    got = tnn.BeamSearchDecoder.tile_beam_merge_with_batch(x, 2)
    ref = jnn.BeamSearchDecoder.tile_beam_merge_with_batch(x, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
