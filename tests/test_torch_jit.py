"""``jit.save`` / ``jit.load`` and the ``Predictor`` of the port against
the JAX package's, on the CPU.

The same numpy weights go into a JAX layer and a port layer; each package
exports its own and loads it back.  The port's loaded outputs must match
the JAX loaded outputs (``rtol 2e-5, atol 1e-5``, as
``tests/test_export.py``): an MLP, and ``gpt_tiny`` with the fused block
and the flash attention at batches 1, 3 and 16 through one dynamic dim.
Across the packages ``meta.json`` is byte-identical and the ``params/``
checkpoints hold the same arrays; the port's program holds the four
kernels as registered ops.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import nn as jnn
from paddle_tpu.inference import Config as JConfig
from paddle_tpu.inference import create_predictor as jcreate
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import gpt_tiny as jgpt_tiny

from paddle_tpu_torch import jit
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_jax_state
from paddle_tpu_torch.distributed.checkpoint import load_sharded
from paddle_tpu_torch.framework.dtype import device_scope
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.observability import compilation
from paddle_tpu_torch.ops.registered import OPS

RTOL, ATOL = 2e-5, 1e-5
SEQ = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with device_scope("cpu"):
        yield
    torch.set_num_threads(prev)


def _np_state(jax_layer):
    return {k: np.asarray(v) for k, v in jax_layer.state_dict().items()}


def _mlp_pair():
    jpt.seed(0)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 4))
    tm = tnn.Sequential(tnn.Linear(8, 16, device="cpu"), tnn.Tanh(),
                        tnn.Linear(16, 4, device="cpu"))
    load_jax_state(tm, _np_state(jm))
    return jm.eval(), tm.eval()


@pytest.fixture(scope="module")
def mlp_artifacts(tmp_path_factory):
    jm, tm = _mlp_pair()
    root = tmp_path_factory.mktemp("mlp")
    spec = [("x", [None, 8])]
    jpt.jit.save(jm, str(root / "jax"),
                 [jpt.jit.InputSpec(s, "float32", name=n) for n, s in spec])
    jit.save(tm, str(root / "port"),
             [jit.InputSpec(s, "float32", name=n) for n, s in spec])
    return str(root / "jax"), str(root / "port"), tm


@pytest.fixture(scope="module")
def gpt_artifacts(tmp_path_factory):
    kw = dict(hidden_dropout=0.0, attention_dropout=0.0,
              use_fused_block=True, use_pallas_attention=True)
    jpt.seed(1)
    jm = JGPT(jgpt_tiny(**kw)).eval()
    tm = GPTForCausalLM(gpt_tiny(**kw), device="cpu")
    load_jax_state(tm, _np_state(jm))
    root = tmp_path_factory.mktemp("gpt")
    jpt.jit.save(jm, str(root / "jax"),
                 [jpt.jit.InputSpec([None, SEQ], "int32", name="input_ids")])
    compilation.reset_tracker()
    jit.save(tm, str(root / "port"),
             [jit.InputSpec([None, SEQ], "int32", name="input_ids")])
    saves = compilation.get_tracker().stats("jit.save")
    return str(root / "jax"), str(root / "port"), tm.eval(), saves


def test_mlp_round_trip_matches_the_jax_artifact(mlp_artifacts):
    jdir, tdir, tm = mlp_artifacts
    x = np.random.RandomState(0).randn(5, 8).astype(np.float32)
    want = np.asarray(jpt.jit.load(jdir)(x))
    got = jit.load(tdir)(x).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        np.testing.assert_array_equal(got, tm(torch.as_tensor(x)).numpy())


@pytest.mark.parametrize("batch", [1, 3, 16])
def test_fused_gpt_round_trip_matches_the_jax_artifact(gpt_artifacts, batch):
    jdir, tdir, tm, _ = gpt_artifacts
    ids = np.random.RandomState(batch).randint(0, 1000, (batch, SEQ)
                                               ).astype(np.int32)
    want = np.asarray(jpt.jit.load(jdir)(ids))
    got = jit.load(tdir)(ids).numpy()
    assert got.shape == (batch, SEQ, 1024)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        eager = tm(torch.as_tensor(ids)).numpy()
    # the artifact's attention is the flash op's plain version, eager
    # CPU's the top-left reference: equal in exact arithmetic
    np.testing.assert_allclose(got, eager, rtol=RTOL, atol=ATOL)


def test_the_exported_graph_holds_the_registered_ops(gpt_artifacts):
    _, tdir, _, saves = gpt_artifacts
    layer = jit.load(tdir)
    targets = {str(n.target) for n in layer.program.graph.nodes
               if n.op == "call_function"}
    for op in OPS:
        assert f"{op.replace('::', '.')}.default" in targets, op
    # gpt_tiny's two blocks: K1, K2, K3 and the flash forward once each
    counts = {op: sum(str(n.target).startswith(op.replace("::", "."))
                      for n in layer.program.graph.nodes) for op in OPS}
    assert set(counts.values()) == {2}, counts
    # no weight in the program: the params are its inputs
    assert not layer.program.state_dict
    assert saves == {"calls": 1, "traces": 1, "retraces": 0, "storms": 0}


@pytest.mark.parametrize("which", ["mlp", "gpt"])
def test_meta_json_is_byte_identical_and_params_equal(mlp_artifacts,
                                                      gpt_artifacts, which):
    jdir, tdir = (mlp_artifacts if which == "mlp" else gpt_artifacts)[:2]
    with open(os.path.join(jdir, "meta.json"), "rb") as f, \
            open(os.path.join(tdir, "meta.json"), "rb") as g:
        assert f.read() == g.read()
    jparams = load_sharded(os.path.join(jdir, "params"))
    tparams = load_sharded(os.path.join(tdir, "params"))
    assert sorted(jparams) == sorted(tparams)
    for k in jparams:
        assert jparams[k].dtype == tparams[k].dtype, k
        assert torch.equal(jparams[k], tparams[k]), k


def test_predictor_facade_matches_jax(mlp_artifacts):
    jdir, tdir, _ = mlp_artifacts
    x = np.random.RandomState(1).randn(3, 8).astype(np.float32)
    outs = {}
    for name, (cfg, make, d) in {"jax": (JConfig, jcreate, jdir),
                                 "port": (Config, create_predictor,
                                          tdir)}.items():
        pred = make(cfg(d))
        assert pred.get_input_names() == ["x"]
        pred.get_input_handle("x").copy_from_cpu(x)
        pred.run()
        assert pred.get_output_names() == ["output_0"]
        outs[name] = pred.get_output_handle("output_0").copy_to_cpu()
    assert isinstance(outs["port"], np.ndarray)
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=RTOL,
                               atol=ATOL)


def test_a_jax_artifact_is_refused_with_what_it_holds(mlp_artifacts):
    jdir, _, _ = mlp_artifacts
    with pytest.raises(Exception, match="model.stablehlo"):
        jit.load(jdir)


def test_input_spec_json_and_dynamic_dims():
    spec = jit.InputSpec([None, -1, 8], torch.int32, name="ids")
    assert spec.dynamic() == [0, 1]
    assert json.dumps(spec.to_json()) == json.dumps(
        jpt.jit.InputSpec([None, -1, 8], "int32", name="ids").to_json())
    assert tuple(spec.example().shape) == (2, 2, 8)


def test_to_static_keeps_the_decorator_conventions():
    @jit.to_static
    def f(a):
        return a * 2

    @jit.to_static(input_spec=[jit.InputSpec([3])])
    def g(a):
        return a + 1
    jit.ProgramTranslator.get_instance().enable(False)
    try:
        assert torch.equal(f(torch.ones(3)), 2 * torch.ones(3))
    finally:
        jit.ProgramTranslator.get_instance().enable(True)
    assert torch.equal(g(torch.ones(3)), 2 * torch.ones(3))
    assert jit.not_to_static(f).__not_to_static__


def test_traced_layer_saves_at_its_example_shapes(tmp_path):
    _, tm = _mlp_pair()
    x = torch.as_tensor(np.random.RandomState(2).randn(4, 8)
                        .astype(np.float32))
    out, traced = jit.TracedLayer.trace(tm, [x])
    traced.save_inference_model(str(tmp_path / "traced"))
    np.testing.assert_array_equal(jit.load(str(tmp_path / "traced"))(x),
                                  out.numpy())
