"""The paddle API surface of the PyTorch port against the JAX package's:
every public callable of the JAX top level, ``linalg``, ``fft``,
``signal`` and ``autograd`` exists in the port, with the same parameter
names, or is in ``TO_PORT`` below with the ``ROADMAP.md`` item it waits on.

Parameter names: the JAX function's named parameters (``*args`` and
``**kwargs`` aside) must equal the port's; where the JAX function forwards
``*args`` / ``**kwargs`` (its thin jax.numpy wrappers), they must open the
port's list, which may name what the wrapper forwarded.  A callable whose
signature one side cannot report (a dtype, the tensor type) must exist.
"""
import inspect
import types

import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as tpt

# JAX top-level names the port does not have yet, with the ROADMAP.md
# item each waits on ("by design" names are in its list of by-design
# differences)
TO_PORT = {
    "batch": "Queue 1 item 12 (reader.py)",
    "key_scope": "by design: JAX key streams; the port draws from "
                 "framework.random's torch.Generator streams",
    "next_key": "by design: JAX key streams; the port draws from "
                "framework.random's torch.Generator streams",
    "install_reference_method_contract": "by design: the port installs "
                                         "its Tensor methods in one pass "
                                         "(install_tensor_methods)",
}

NAMESPACES = [("", jpt, tpt), ("linalg", jpt.linalg, tpt.linalg),
              ("fft", jpt.fft, tpt.fft), ("signal", jpt.signal, tpt.signal),
              ("autograd", jpt.autograd, tpt.autograd)]


def _public_callables(mod):
    return {n: getattr(mod, n) for n in dir(mod)
            if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)
            and callable(getattr(mod, n))}


def _params(fn):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    var = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
    return ([p.name for p in sig.parameters.values() if p.kind not in var],
            any(p.kind in var for p in sig.parameters.values()))


CASES = [(ns, name) for ns, jmod, _ in NAMESPACES
         for name in sorted(_public_callables(jmod))]


@pytest.mark.parametrize("ns,name", CASES,
                         ids=[f"{ns or 'top'}.{n}" for ns, n in CASES])
def test_jax_callable_is_in_the_port(ns, name):
    jmod = dict((n, j) for n, j, _ in NAMESPACES)[ns]
    tmod = dict((n, t) for n, _, t in NAMESPACES)[ns]
    if not ns and name in TO_PORT:
        assert not hasattr(tmod, name), f"{name} is ported: drop it from TO_PORT"
        return
    assert hasattr(tmod, name), f"{ns or 'top'}.{name} missing in the port"
    jp, tp = _params(getattr(jmod, name)), _params(getattr(tmod, name))
    if jp is None or tp is None:
        return
    (jnames, jvar), (tnames, _) = jp, tp
    if jvar:
        assert tnames[:len(jnames)] == jnames, (name, jnames, tnames)
    else:
        assert tnames == jnames, (name, jnames, tnames)


def test_to_port_names_are_jax_names():
    assert set(TO_PORT) <= set(_public_callables(jpt))


def test_surface_sizes():
    # the JAX namespaces' public callables, and how many the port lacks
    sizes = {ns or "top": len(_public_callables(j)) for ns, j, _ in NAMESPACES}
    assert sizes["top"] >= 290 and sizes["linalg"] >= 24
    assert sizes["fft"] == 22
    missing = [n for n in _public_callables(jpt) if not hasattr(tpt, n)]
    assert sorted(missing) == sorted(TO_PORT)
