"""The port's framework helpers (``paddle_tpu_torch/framework/``) against
the JAX package's on the CPU: flags with their environment overrides and
the two refused routing flags, the flag readers of ``log`` / ``hapi`` /
``io``, execution mode, nan/inf debugging, meta validation, dtypes, places
and the current device."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.framework.debug as jdebug
import paddle_tpu.framework.dtype as jdtype
import paddle_tpu.framework.flags as jflags
import paddle_tpu.framework.infermeta as jim
import paddle_tpu.framework.mode as jmode
import paddle_tpu_torch as tpt
from paddle_tpu_torch.framework import debug as tdebug
from paddle_tpu_torch.framework import dtype as tdtype
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework import infermeta as tim
from paddle_tpu_torch.framework import mode as tmode
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               UnavailableError,
                                               UnimplementedError)


@pytest.fixture(autouse=True)
def _restore_state():
    """Flags set, the current device and the static mode are restored."""
    flags_set = dict(tflags._set)
    current = tdtype._current
    static = tmode._static_mode
    yield
    tflags._set.clear()
    tflags._set.update(flags_set)
    tdtype._current = current
    tmode._static_mode = static


# -- flags ---------------------------------------------------------------------
def test_flag_table_is_the_jax_table_less_the_routing_flags():
    want = set(jflags.get_flags()) - {"use_pallas_kernels",
                                      "pallas_interpret_routing"}
    assert set(tflags.get_flags()) == want
    for name in want - {"dataloader_use_native"}:
        assert tflags._defaults[name] == jflags._defaults[name], name
    # by design: the port has no native transport, so it is off
    assert jflags._defaults["dataloader_use_native"] is True
    assert tflags._defaults["dataloader_use_native"] is False


@pytest.mark.parametrize("name", ["use_pallas_kernels",
                                  "pallas_interpret_routing"])
def test_routing_flags_are_refused(name):
    with pytest.raises(UnimplementedError, match="not supported"):
        tflags.set_flags({name: False})
    assert name not in tflags.get_flags()


def test_unknown_flag_raises_keyerror_as_jax():
    with pytest.raises(KeyError):
        tflags.set_flags({"no_such_flag": 1})
    with pytest.raises(KeyError):
        jflags.set_flags({"no_such_flag": 1})


@pytest.mark.parametrize("default,env,want", [
    (False, "1", True), (False, "yes", True), (True, "0", False),
    (0, "3", 3), (0.5, "0.25", 0.25), ("bfloat16", "float16", "float16")])
def test_env_override_coerces_as_jax(monkeypatch, default, env, want):
    name = f"port_test_flag_{type(default).__name__}_{env}"
    monkeypatch.setenv("FLAGS_" + name, env)
    tflags.define_flag(name, default)
    jflags.define_flag(name, default)
    assert tflags.get_flag(name) == want == jflags.get_flag(name)


def test_env_read_when_the_flag_is_read_and_set_flags_wins(monkeypatch):
    tflags.define_flag("port_test_late_env", 1)
    assert tflags.get_flag("port_test_late_env") == 1
    monkeypatch.setenv("FLAGS_port_test_late_env", "7")
    assert tflags.get_flag("port_test_late_env") == 7
    v = tflags.version()
    tflags.set_flags({"port_test_late_env": 9})
    assert tflags.version() > v
    assert tflags.get_flags("port_test_late_env") == {"port_test_late_env": 9}


def test_log_level_reader_follows_set_flags(monkeypatch):
    from paddle_tpu_torch.framework import log
    monkeypatch.delenv("FLAGS_log_level", raising=False)
    assert log.get_log_level() == 0
    monkeypatch.setenv("FLAGS_log_level", "2")
    assert log.get_log_level() == 2
    tflags.set_flags({"log_level": 5})
    assert log.get_log_level() == 5


def test_check_nan_inf_reader_follows_set_flags(monkeypatch):
    from paddle_tpu_torch.hapi import model
    assert model.check_nan_inf_enabled is tdebug.check_nan_inf_enabled
    monkeypatch.delenv("FLAGS_check_nan_inf", raising=False)
    assert not tdebug.check_nan_inf_enabled()
    monkeypatch.setenv("FLAGS_check_nan_inf", "1")
    assert tdebug.check_nan_inf_enabled()
    tflags.set_flags({"check_nan_inf": False})
    assert not tdebug.check_nan_inf_enabled()


def test_native_loader_reader_follows_set_flags(monkeypatch):
    from paddle_tpu_torch import io as tio
    monkeypatch.delenv("FLAGS_dataloader_use_native", raising=False)
    ds = tio.TensorDataset([np.zeros((4, 2), np.float32)])
    tio.DataLoader(ds, num_workers=2, places="cpu")
    tflags.set_flags({"dataloader_use_native": True})
    with pytest.raises(UnimplementedError):
        tio.DataLoader(ds, num_workers=2, places="cpu")


def test_top_level_flag_functions():
    assert tpt.get_flags is tflags.get_flags
    assert tpt.set_flags is tflags.set_flags
    assert tpt.framework.define_flag is tflags.define_flag


# -- mode ----------------------------------------------------------------------
def test_static_mode_is_recorded_state_as_jax():
    for m in (tmode, jmode):
        assert m.in_dynamic_mode()
        m.enable_static()
        assert not m.in_dynamic_mode()
        m.disable_static()
        assert m.in_dynamic_mode()
    assert tpt.enable_static is tmode.enable_static


def test_grad_mode_is_torchs_own():
    assert tmode.is_grad_enabled() and torch.is_grad_enabled()
    with tmode.set_grad_enabled(False):
        assert not tmode.is_grad_enabled() and not torch.is_grad_enabled()
        x = torch.ones(2, requires_grad=True)
        assert not (x * 2).requires_grad
    with torch.no_grad():
        assert not tpt.is_grad_enabled()
    with tpt.no_grad():
        assert not tmode.is_grad_enabled()
    with jmode.set_grad_enabled(False):
        assert not jmode.is_grad_enabled()
    assert tmode.is_grad_enabled() and jmode.is_grad_enabled()


# -- debug ---------------------------------------------------------------------
def test_finite_flags_paths_and_values_match_jax():
    a = np.array([1.0, np.nan], np.float32)
    b = np.array([1.0, 2.0], np.float32)
    c = np.array([np.inf], np.float32)
    i = np.array([1, 2], np.int32)
    jtree = {"w": [jnp.asarray(a), jnp.asarray(b)],
             "z": {"c": jnp.asarray(c), "i": jnp.asarray(i)}}
    ttree = {"w": [torch.as_tensor(a), torch.as_tensor(b)],
             "z": {"c": torch.as_tensor(c), "i": torch.as_tensor(i)}}
    jf = {k: bool(v) for k, v in jdebug.finite_flags(jtree).items()}
    tf = {k: bool(v) for k, v in tdebug.finite_flags(ttree).items()}
    assert tf == jf == {"w/0": False, "w/1": True, "z/c": False}


def test_assert_all_finite_message_matches_jax():
    flags = {f"p{i}": i % 3 != 0 for i in range(14)}
    with pytest.raises(FloatingPointError) as te:
        tdebug.assert_all_finite(flags, context="step 3")
    with pytest.raises(FloatingPointError) as je:
        jdebug.assert_all_finite(flags, context="step 3")
    assert str(te.value) == str(je.value)
    tdebug.assert_all_finite({"a": True})


# -- infermeta -----------------------------------------------------------------
def _metas(pkg_meta_of, *arrays):
    return [pkg_meta_of(a, f"x{i}") for i, a in enumerate(arrays)]


@pytest.mark.parametrize("rule,arrays,extra", [
    ("require_rank", [np.zeros((2, 3))], (3,)),
    ("require_rank_in", [np.zeros((2, 3))], ((1, 3),)),
    ("require_dim_match", [np.zeros((2, 3)), np.zeros((4, 5))], None),
    ("require_same_rank", [np.zeros((2, 3)), np.zeros((4,))], ()),
    ("require_broadcastable", [np.zeros((2, 3)), np.zeros((4,))], ()),
    ("require_floating", [np.zeros(3, np.int32)], ()),
    ("require_integer", [np.zeros(3, np.float32)], ()),
])
def test_infermeta_rules_raise_as_jax(rule, arrays, extra):
    tm = _metas(tim.meta_of, *[torch.as_tensor(a) for a in arrays])
    jm = _metas(jim.meta_of, *[jnp.asarray(a) for a in arrays])
    if rule == "require_dim_match":
        targs, jargs = (tm[0], 1, tm[1], 0), (jm[0], 1, jm[1], 0)
    else:
        targs, jargs = (*tm, *extra), (*jm, *extra)
    with pytest.raises(InvalidArgumentError) as te:
        getattr(tim, rule)(*targs, "op")
    with pytest.raises(Exception) as je:
        getattr(jim, rule)(*jargs, "op")
    assert type(je.value).__name__ == "InvalidArgumentError"
    # the same message, dtype spelling aside
    assert (str(te.value).replace("int32", "I").replace("float32", "F")
            .replace("float64", "F") ==
            str(je.value).replace("int32", "I").replace("float32", "F")
            .replace("float64", "F"))


def test_infermeta_passes_and_decorates():
    x = torch.zeros(2, 3)
    m = tim.meta_of(x, "x")
    assert m.shape == (2, 3) and m.ndim == 2 and m.dtype == torch.float32
    tim.require_rank(m, 2, "op")
    tim.require_floating(m, "op")
    tim.require_floating(tim.meta_of(torch.zeros(1, dtype=torch.bfloat16)),
                         "op")
    tim.require_integer(tim.meta_of(np.zeros(1, np.int64)), "op")
    assert tim.meta_of(None) is None
    assert tim.meta_of([[1, 2]]).shape == (1, 2)

    def rule(a, b):
        tim.require_broadcastable(tim.meta_of(a, "a"), tim.meta_of(b, "b"),
                                  "add2")

    @tim.infer_meta(rule)
    def add2(a, b):
        return a + b
    assert add2.__infermeta__ is rule
    assert torch.equal(add2(torch.ones(2), torch.ones(1)), torch.full((2,), 2.))
    with pytest.raises(InvalidArgumentError, match="add2"):
        add2(torch.ones(2), torch.ones(3))


# -- dtypes, places, the current device ----------------------------------------
@pytest.mark.parametrize("spec", ["float32", "fp16", "bf16", "int64", "bool",
                                  "complex64", np.float64, np.int8,
                                  np.dtype("uint8")])
def test_convert_dtype_names_as_jax(spec):
    t = tdtype.convert_dtype(spec)
    j = jdtype.convert_dtype(spec)
    assert tdtype.dtype_name(t) == jnp.dtype(j).name
    assert tdtype.convert_dtype(t) is t and tdtype.convert_dtype(None) is None
    with pytest.raises(ValueError):
        tdtype.convert_dtype("float128")


def test_places():
    assert tpt.CPUPlace().device == torch.device("cpu")
    assert tpt.CUDAPlace(1).device == torch.device("cuda", 1)
    pinned = tpt.CUDAPinnedPlace()
    assert pinned.device == torch.device("cpu") and pinned.pinned
    assert tpt.CPUPlace() == tpt.CPUPlace() != pinned
    for place in (tpt.TPUPlace, tpt.NPUPlace):
        with pytest.raises(UnavailableError, match="NVIDIA"):
            place(0)
    assert not tpt.framework.is_compiled_with_tpu()


@pytest.mark.parametrize("name,want", [("cpu", "cpu"), ("gpu", "gpu:0"),
                                       ("gpu:1", "gpu:1"), ("cuda:2", "gpu:2"),
                                       ("tpu", "gpu:0")])
def test_set_device_lands_on_cuda_as_jax_lands_on_the_accelerator(name, want):
    place = tpt.set_device(name)
    assert tpt.get_device() == want
    assert place.device.type == ("cpu" if name == "cpu" else "cuda")
    with pytest.raises(ValueError):
        tpt.set_device("abacus")


def test_device_scope_restores_the_device_it_found():
    tdtype.set_device("gpu:1")
    with tdtype.device_scope("cpu") as dev:
        assert dev == torch.device("cpu") and tpt.get_device() == "cpu"
    assert tpt.get_device() == "gpu:1"
    with pytest.raises(RuntimeError):
        with tdtype.device_scope("cpu"):
            raise RuntimeError("inside")
    assert tpt.get_device() == "gpu:1"


def test_default_device_is_the_card():
    tdtype._current = None
    assert tpt.get_device() == "gpu:0"
    assert tdtype.current_device().type == "cuda"
    assert tpt.resolve_device().type == "cuda" if torch.cuda.is_available() \
        else True
    tpt.set_device("cpu")
    assert tpt.resolve_device() == torch.device("cpu")
    assert tpt.resolve_device("cpu") == torch.device("cpu")
