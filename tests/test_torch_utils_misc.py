"""The port's ``utils`` (``unique_name``, ``cpp_extension``, ``download``,
``deprecated`` / ``try_import`` / ``require_version`` / ``run_check``),
``hub``, ``version``, ``sysconfig``, ``callbacks``, ``amp.auto_cast``'s
custom lists and the optimizer helpers ``append_regularization_ops`` /
``get_opti_var_name_list``, against the JAX package's, on the CPU.

Exact throughout (names, lists, ids, host op results).  By design
``version`` reports PyTorch's build (``with_gpu`` / ``cuda()`` /
``cudnn()``) and ``cpp_extension`` builds under the port's ``build/``.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpt
import paddle_tpu.hub as jhub
import paddle_tpu.utils as jutils
from paddle_tpu.utils import cpp_extension as jcpp
from paddle_tpu.utils import download as jdownload
from paddle_tpu.utils import unique_name as jun

import paddle_tpu_torch as tpt
import paddle_tpu_torch.hub as thub
import paddle_tpu_torch.utils as tutils
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework.dtype import device_scope
from paddle_tpu_torch.framework.errors import UnavailableError
from paddle_tpu_torch.utils import cpp_extension as tcpp
from paddle_tpu_torch.utils import download as tdownload
from paddle_tpu_torch.utils import unique_name as tun


@pytest.fixture(scope="module", autouse=True)
def _no_jax_mesh():
    # a hybrid mesh left set by an earlier JAX test file on this xdist
    # worker would shard the JAX side (and refuse its ServingEngine in
    # later files); these tests compare single-device runs
    from paddle_tpu.distributed import topology
    topology.set_hybrid_communicate_group(None)
    yield
    topology.set_hybrid_communicate_group(None)



def test_unique_name_sequences_equal_jax():
    def run(mod):
        out = [mod.generate("fc"), mod.generate("fc"), mod.generate("conv")]
        with mod.guard():
            out += [mod.generate("fc"), mod.generate("fc")]
        out.append(mod.generate("fc"))
        old = mod.switch()
        out += [mod.generate("fc"), mod.generate("conv")]
        mod.switch(old)
        out.append(mod.generate("conv"))
        return out
    with jun.guard(), tun.guard():
        assert run(tun) == run(jun) == [
            "fc_0", "fc_1", "conv_0", "fc_0", "fc_1", "fc_2", "fc_0",
            "conv_0", "conv_1"]


HUBCONF = '''
def tiny(scale=1):
    """A tiny entry point."""
    return {"scale": scale}


def _private():
    return None
'''


def test_hub_serves_a_local_repo_as_jax(tmp_path):
    (tmp_path / "hubconf.py").write_text(HUBCONF)
    repo = str(tmp_path)
    assert thub.list(repo) == jhub.list(repo) == ["tiny"]
    assert thub.help(repo, "tiny") == jhub.help(repo, "tiny")
    assert thub.load(repo, "tiny", scale=3) == jhub.load(repo, "tiny",
                                                          scale=3)
    for bad in (("https://example.invalid/repo", "tiny"), (repo, "nope")):
        with pytest.raises(Exception):
            thub.load(*bad)


def test_download_is_local_cache_only(tmp_path, monkeypatch):
    for mod in (tdownload, jdownload):
        monkeypatch.setattr(mod, "WEIGHTS_HOME", str(tmp_path))
    url = "https://example.invalid/models/w.pdparams"
    for mod in (tdownload, jdownload):
        with pytest.raises(RuntimeError, match="provision"):
            mod.get_weights_path_from_url(url)
    (tmp_path / "w.pdparams").write_bytes(b"weights")
    md5 = hashlib.md5(b"weights").hexdigest()
    assert tdownload.get_weights_path_from_url(url, md5) == \
        jdownload.get_weights_path_from_url(url, md5) == \
        str(tmp_path / "w.pdparams")
    with pytest.raises(RuntimeError, match="md5"):
        tdownload.get_weights_path_from_url(url, "0" * 32)


C_SRC = r'''
#include <stdint.h>
extern "C" void scale_add(const float* in, float* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = 2.0f * in[i] + 1.0f;
}
'''


def test_cpp_extension_host_op_matches_jax(tmp_path):
    src = tmp_path / "scale_add.cc"
    src.write_text(C_SRC)
    lib = tcpp.load("scale_add", [str(src)])
    from paddle_tpu_torch._kernels import BUILD_DIR
    assert pathlib.Path(tcpp.get_build_directory()) == \
        BUILD_DIR / "extensions" or os.environ.get(
            "PADDLE_TPU_EXTENSION_DIR")
    built = [f for f in os.listdir(tcpp.get_build_directory())
             if f.startswith("scale_add-")]
    assert built and all(f.endswith(".so") for f in built)
    top = tcpp.custom_op(lib, "scale_add")
    jop = jcpp.custom_op(jcpp.load("scale_add", [str(src)]), "scale_add")
    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    got = top(torch.from_numpy(x))
    assert got.shape == (3, 5) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jop(
        jnp.asarray(x))))
    np.testing.assert_array_equal(top(x).numpy(), 2 * x + 1)
    # the same sources load the built library again (no rebuild)
    assert tcpp.load("scale_add", [str(src)])._name == lib._name
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++")
    with pytest.raises(Exception, match="build failed"):
        tcpp.load("bad", [str(bad)])
    assert not [f for f in os.listdir(tcpp.get_build_directory())
                if f.startswith("bad-")]


def test_setuptools_extension_factories():
    ext = tcpp.CppExtension(["a.cc"], name="hostops")
    assert ext.name == "hostops" and ext.sources == ["a.cc"]
    assert ext.language == "c++"
    host = tcpp.CUDAExtension(["b.cc"], name="host_only")
    assert host.name == "host_only" and host.sources == ["b.cc"]


def test_utils_helpers_match_jax(capsys):
    for mod in (jutils, tutils):
        @mod.deprecated(update_to="new_fn", since="0.1", reason="renamed")
        def old_fn(x):
            return x * 2
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert old_fn(2) == 4
        assert w and issubclass(w[0].category, DeprecationWarning)
        assert "new_fn" in str(w[0].message) and "0.1" in str(w[0].message)
        assert mod.try_import("json").__name__ == "json"
        with pytest.raises(ImportError):
            mod.try_import("no_such_module_here")
        assert mod.require_version("0.0.1")
        with pytest.raises(Exception):
            mod.require_version("99.0.0")
        with pytest.raises(Exception):
            mod.require_version("0.0.1", "0.0.2")
    with device_scope("cpu"):
        assert tutils.run_check() is True
    assert "installed successfully on cpu" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(UnavailableError):
            tutils.run_check()
    assert set(jutils.__all__) <= set(tutils.__all__)


def test_version_reports_the_torch_build_by_design():
    v = tpt.version
    assert v.full_version == jpt.version.full_version == tpt.__version__
    assert (v.major, v.minor, v.patch) == ("0", "1", "0")
    # by design: the JAX build reports a TPU; the port, torch's CUDA build
    assert jpt.version.with_tpu == "ON" and v.with_tpu == "OFF"
    assert v.with_gpu == ("ON" if torch.version.cuda else "OFF")
    assert v.cuda() == (torch.version.cuda or False)
    if not torch.version.cuda:
        assert v.cudnn() is False
    v.show()


def test_sysconfig_and_callbacks():
    inc = pathlib.Path(tpt.sysconfig.get_include())
    assert inc == pathlib.Path(tpt.__file__).parent / "io" / "_native"
    assert (inc / "shm_ring.cc").exists()
    assert pathlib.Path(tpt.sysconfig.get_lib()).is_dir()
    assert tpt.callbacks.__all__ == jpt.callbacks.__all__
    for name in tpt.callbacks.__all__:
        assert getattr(tpt.callbacks, name) is getattr(tpt.hapi.callbacks,
                                                       name)


def test_auto_cast_custom_lists_follow_the_jax_arithmetic():
    from paddle_tpu import amp as jamp
    white, black = set(tamp.WHITE_OPS), set(tamp.BLACK_OPS)
    already = next(iter(white))
    seen = {}
    for name, mod in (("jax", jamp), ("port", tamp)):
        with mod.auto_cast(custom_white_list=["my_gemm", already],
                           custom_black_list={"my_norm"}, level="O1",
                           dtype="bfloat16"):
            seen[name] = ({"my_gemm", already} <= mod.WHITE_OPS,
                          "my_norm" in mod.BLACK_OPS)
        seen[name] += ("my_gemm" in mod.WHITE_OPS, already in mod.WHITE_OPS,
                       "my_norm" in mod.BLACK_OPS)
    assert seen["port"] == seen["jax"] == (True, True, False, True, False)
    assert tamp.WHITE_OPS == white and tamp.BLACK_OPS == black
    from paddle_tpu_torch.amp import state
    x = torch.ones(2)
    with tamp.auto_cast(custom_white_list=["my_gemm"]):
        assert state.cast_for_op("my_gemm", x).dtype == torch.bfloat16
        assert state.cast_for_op("other_op", x).dtype == torch.float32


def test_optimizer_helpers_match_jax():
    from paddle_tpu.regularizer import L1Decay as JL1, L2Decay as JL2
    from paddle_tpu_torch.regularizer import L1Decay, L2Decay
    r = np.random.RandomState(0)
    ps = [r.randn(3, 2).astype(np.float32), r.randn(4).astype(np.float32)]
    gs = [r.randn(3, 2).astype(np.float32), r.randn(4).astype(np.float32)]
    named = [(f"p{i}", torch.nn.Parameter(torch.from_numpy(p.copy())))
             for i, p in enumerate(ps)]
    opt = topt.Adam(learning_rate=0.1, parameters=named)
    jo = jpt.optimizer.Adam(learning_rate=0.1)
    pairs_t = [(p, torch.from_numpy(g)) for (_, p), g in zip(named, gs)]
    pairs_j = [(jnp.asarray(p), jnp.asarray(g)) for p, g in zip(ps, gs)]
    for treg, jreg in ((L1Decay(0.1), JL1(0.1)), (L2Decay(0.2), JL2(0.2)),
                       (None, None)):
        t = opt.append_regularization_ops(pairs_t, treg)
        j = jo.append_regularization_ops(pairs_j, jreg)
        for (_, tg), (_, jg) in zip(t, j):
            np.testing.assert_allclose(tg.detach().numpy(), np.asarray(jg),
                                       rtol=1e-6, atol=1e-7)
    want = jo.init({n: jnp.asarray(p) for (n, _), p in zip(named, ps)})
    expected = sorted(f"{n}.{s}" for n, slots in want["slots"].items()
                      for s in slots)
    assert sorted(opt.get_opti_var_name_list()) == expected
    assert expected == ["p0.moment1", "p0.moment2", "p1.moment1",
                        "p1.moment2"]
    sgd = topt.SGD(learning_rate=0.1, parameters=named)
    assert sgd.get_opti_var_name_list() == []
