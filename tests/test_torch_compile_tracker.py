"""The port's compile tracker and persistent cache against the JAX
package's, the ``/statusz`` compile section, the doctor on a port run
directory, and the ``onnx`` gate and ``cost_model`` of the port.

Signatures and diffs must equal the JAX tracker's for the same numpy
arguments (a torch tensor is described as the same array would be); a
storm fires after ``storm_threshold`` retraces; the doctor's
``check_compilation`` names the argument of a port run's retrace storm.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.cost_model import CostModel as JCostModel
from paddle_tpu.observability import compilation as jcomp
from paddle_tpu.observability.registry import MetricsRegistry as JRegistry

from paddle_tpu_torch import _kernels, onnx
from paddle_tpu_torch.cost_model import CostModel
from paddle_tpu_torch.observability import compilation as tcomp
from paddle_tpu_torch.observability import compilecache, doctor
from paddle_tpu_torch.observability import monitor
from paddle_tpu_torch.observability.registry import MetricsRegistry
from paddle_tpu_torch.observability.sinks import MetricsWriter, metrics_dir

F32 = np.zeros((2, 8), np.float32)
ARGS = [F32, np.zeros(3, np.int32), 3, 2.5, None, "abc", True, (),
        (F32, 1), [1, np.zeros(1, np.int64)],
        {"b": F32, "a": (1, None)}, {"x": [F32]}, (F32,)]


def _torch(a):
    if isinstance(a, np.ndarray):
        return torch.as_tensor(a)
    if isinstance(a, tuple):
        return tuple(_torch(e) for e in a)
    if isinstance(a, list):
        return [_torch(e) for e in a]
    if isinstance(a, dict):
        return {k: _torch(v) for k, v in a.items()}
    return a


@pytest.mark.parametrize("i", range(len(ARGS)))
def test_signature_equals_jax(i):
    a = ARGS[i]
    want = jcomp.arg_signature(a)
    assert tcomp.arg_signature(a) == want
    assert tcomp.arg_signature(_torch(a)) == want


def test_bfloat16_tensor_reads_as_jax_bfloat16():
    got = tcomp.arg_signature(torch.zeros(4, 2, dtype=torch.bfloat16))
    want = jcomp.arg_signature(jnp.zeros((4, 2), jnp.bfloat16))
    assert got == want


def _observe_sequence(mod, reg, arrays):
    tr = mod.CompileTracker(registry=reg, storm_threshold=3,
                            storm_window=16)
    recs = [tr.observe("step", [a, 2], arg_names=["batch", "k"])
            for a in arrays]
    return tr, recs


def test_retrace_diffs_and_storm_equal_jax():
    arrays = [np.zeros((b, 8), np.float32) for b in (2, 2, 3, 4, 5, 2)]
    treg, jreg = MetricsRegistry(), JRegistry()
    ttr, trecs = _observe_sequence(tcomp, treg,
                                   [torch.as_tensor(a) for a in arrays])
    jtr, jrecs = _observe_sequence(jcomp, jreg, arrays)
    assert trecs == jrecs
    assert trecs[1] is None                         # a cache hit
    assert trecs[2]["changed"] == [{"arg": "batch", "detail":
                                    "float32[2,8] -> float32[3,8]"}]
    assert ttr.stats("step") == jtr.stats("step") == {
        "calls": 6, "traces": 4, "retraces": 3, "storms": 1}
    snap = treg.snapshot()
    assert snap["compile.storms[fn=step]"]["value"] == 1
    assert snap["compile.retraces[fn=step]"]["value"] == 3
    assert snap["compile.cache_hit[fn=step]"]["value"] == 2


def test_track_jit_wraps_a_callable():
    reg = MetricsRegistry()
    tr = tcomp.CompileTracker(registry=reg)
    f = tcomp.track_jit(lambda x: x * 2, name="double", tracker=tr)
    for n in (2, 2, 3):
        f(torch.ones(n))
    assert tr.stats("double") == {"calls": 3, "traces": 2, "retraces": 1,
                                  "storms": 0}
    assert tcomp.track is tcomp.track_jit


def test_statusz_compile_is_filled_from_the_tracker():
    tcomp.reset_tracker()
    try:
        tcomp.get_tracker().observe("generate.decode_step", [8, 640, 0.0, 0],
                                    arg_names=["batch", "capacity",
                                               "temperature", "top_k"])
        tcomp.get_tracker().observe("generate.decode_step", [4, 640, 0.0, 0],
                                    arg_names=["batch", "capacity",
                                               "temperature", "top_k"])
        page = monitor.StatusServer(registry=MetricsRegistry()).statusz()
        assert page["compile"] == {"generate.decode_step": {
            "calls": 2, "traces": 2, "retraces": 1, "storms": 0}}
    finally:
        tcomp.reset_tracker()


def test_doctor_names_the_storm_of_a_port_run(tmp_path):
    run_dir = str(tmp_path)
    reg = MetricsRegistry()
    writer = reg.add_sink(MetricsWriter(metrics_dir(run_dir), worker_id=0,
                                        flush_every=1))
    tr = tcomp.CompileTracker(registry=reg)
    for b in range(1, 6):
        tr.observe("generate.decode_step", [b, 640, 0.0, 0],
                   arg_names=["batch", "capacity", "temperature", "top_k"])
    reg.remove_sink(writer)
    found = [f for f in doctor.diagnose(run_dir)["findings"]
             if f["kind"] == "retrace_storm"]
    assert found and found[0]["data"]["argument"] == "batch"
    assert found[0]["data"]["function"] == "generate.decode_step"


def test_the_persistent_cache_is_the_kernel_build_directory(tmp_path,
                                                            monkeypatch):
    try:
        assert compilecache.maybe_enable_persistent_cache() == \
            str(_kernels.BUILD_DIR)
        monkeypatch.setenv(compilecache.ENV, str(tmp_path / "cache"))
        assert compilecache.maybe_enable_persistent_cache() == \
            str(tmp_path / "cache")
        assert _kernels.BUILD_DIR == tmp_path / "cache"
        assert compilecache.persistent_cache_dir() == str(tmp_path / "cache")
    finally:
        compilecache.reset_for_tests()
    assert _kernels.BUILD_DIR == _kernels.DEFAULT_BUILD_DIR
    assert compilecache.persistent_cache_dir() is None


def test_onnx_gate_names_jit_save():
    err = NotImplementedError if onnx.onnx_available() else RuntimeError
    with pytest.raises(err, match=r"jit\.save"):
        onnx.export(torch.nn.Linear(2, 2), "m.onnx")


def test_cost_model_flops_equal_jax_and_xla_only_keys_are_none():
    a = np.random.RandomState(0).randn(64, 32).astype(np.float32)
    b = np.random.RandomState(1).randn(32, 16).astype(np.float32)
    want = JCostModel().profile_measure(lambda x, y: x @ y,
                                        [jnp.asarray(a), jnp.asarray(b)])
    got = CostModel().profile_measure(lambda x, y: x @ y,
                                      [torch.as_tensor(a),
                                       torch.as_tensor(b)], device="cpu")
    assert got["flops"] == want["flops"] == 2 * 64 * 32 * 16
    assert got["bytes_accessed"] is None and got["transcendentals"] is None
    assert got["time"] > 0
    json.dumps(got)
    assert not os.path.exists("m.onnx")
