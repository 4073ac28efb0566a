"""Port parity of the checkpoint format and its fingerprint, on the CPU,
against the JAX package (``distributed/checkpoint.py``,
``distributed/fingerprint.py``, ``utils/retry.py``):

- a checkpoint written by the port loads in the JAX package, and one
  written by the JAX package loads in the port, bf16 leaves included, each
  loader verifying the other's CRCs and ``mlh32/1`` stamp; a JAX optimizer
  state resumes in the port through ``optimizer_state_from_jax``;
- the ``mlh32/1`` digests agree bit for bit across packages and between
  the port's device (torch) and host (numpy) paths, over dtypes, sizes
  around the chunk and padding;
- a truncated, flipped or missing shard, a torn manifest, and a state
  changed between stamping and writing raise in both packages;
- an async save lands, and its writer's error comes out of ``wait()``;
  transient write errors are retried.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu.distributed import fingerprint as jfp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import optimizer_state_from_jax
from paddle_tpu_torch.distributed import checkpoint as tck
from paddle_tpu_torch.distributed import fingerprint as tfp
from paddle_tpu_torch.utils import fsio as tfsio
from paddle_tpu_torch.utils.retry import (RetriesExhausted, RetryPolicy,
                                          retry_call)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work.  Under the suite's
    six xdist workers, eight OpenMP threads a worker oversubscribe the
    eight cores and spin: six translation recipes run at once took 916 s
    each with eight threads and 5 s each with one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SLEEPLESS = RetryPolicy(max_attempts=4, base_delay=0.0, sleep=lambda s: None)


@pytest.fixture(autouse=True)
def _no_sleep(monkeypatch):
    monkeypatch.setattr(tck, "IO_RETRY_POLICY", SLEEPLESS)
    monkeypatch.setattr(jck, "IO_RETRY_POLICY", SLEEPLESS)


def _bits(x):
    """A leaf's raw bits as a numpy array (bf16 as uint16)."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _port_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "model": {"h.0.w": torch.randn(33, 7, generator=g).to(
            torch.bfloat16),
            "h.0.b": torch.randn(7, generator=g)},
        "optimizer": {"state": {
            "step": torch.tensor(3, dtype=torch.int32),
            "slots": {"h.0.w": {"moment1": torch.randn(33, 7, generator=g),
                                "moment2": torch.rand(33, 7, generator=g)}},
            "master": {"h.0.w": torch.randn(33, 7, generator=g),
                       "h.0.b": None}}},
        "scheduler": {"last_epoch": 2},
        "rng": {"cpu": torch.Generator().manual_seed(5).get_state()},
        "flags": [torch.tensor([True, False]), torch.zeros(0)],
    }


def _stamp(fp, tree):
    return {**fp.TreeFingerprint().digest(tree).meta(),
            "exclude": list(fp.DEFAULT_EXCLUDE)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {} if tree is None else {prefix: tree}


def test_port_checkpoint_loads_in_jax(tmp_path):
    tree = _port_tree()
    path = str(tmp_path / "ck")
    tck.save_sharded(tree, path, integrity=_stamp(tfp, tree))
    assert jck.verify_sharded(path) == []
    # the JAX loader re-hashes the restored tree against the port's stamp
    loaded = jck.load_sharded(path)
    want, got = _flat(tree), _flat(loaded)
    assert set(got) == set(want)
    for k, v in want.items():
        ref = _bits(v) if torch.is_tensor(v) else np.asarray(v, np.int32)
        assert got[k].dtype.name == (
            "bfloat16" if torch.is_tensor(v) and v.dtype == torch.bfloat16
            else ref.dtype.name), k
        np.testing.assert_array_equal(_bits(got[k]), ref, err_msg=k)
    assert tck.read_integrity(path) == jck.read_integrity(path)


def _jax_state():
    r = np.random.RandomState(1)
    params = {"h.0.w": jnp.asarray(r.randn(33, 7), jnp.bfloat16),
              "h.0.b": jnp.asarray(r.randn(7), jnp.float32)}
    o = jopt.AdamW(learning_rate=0.01, weight_decay=0.1)
    st = o.init(params)
    grads = {k: jnp.asarray(r.randn(*v.shape), v.dtype)
             for k, v in params.items()}
    params, st = o.apply_gradients(grads, params, st)
    return o, params, st, r


def test_jax_checkpoint_loads_in_the_port_and_resumes(tmp_path):
    jo, params, st, r = _jax_state()
    tree = {"params": params, "opt": st}
    path = str(tmp_path / "ck")
    jck.save_sharded(tree, path, integrity=_stamp(jfp, tree))
    assert tck.verify_sharded(path) == []
    loaded = tck.load_sharded(path)
    assert loaded["params"]["h.0.w"].dtype == torch.bfloat16
    for k, v in _flat({"params": params, "opt": st}).items():
        np.testing.assert_array_equal(_bits(_flat(loaded)[k]),
                                      _bits(np.asarray(v)), err_msg=k)
    # into a port model + optimizer: one more step on each side agrees
    tp = {k: torch.nn.Parameter(v.clone())
          for k, v in loaded["params"].items()}
    to = topt.AdamW(learning_rate=0.01, weight_decay=0.1,
                    parameters=list(tp.items()))
    optimizer_state_from_jax(loaded["opt"], to)
    assert int(to.state_dict()["state"]["step"]) == 1
    grads = {k: r.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
    for k, p in tp.items():
        p.grad = torch.from_numpy(grads[k]).to(p.dtype)
    to.step()
    params, st = jo.apply_gradients(
        {k: jnp.asarray(v, params[k].dtype) for k, v in grads.items()},
        params, st)
    for k, p in tp.items():
        np.testing.assert_array_equal(_bits(p.detach()),
                                      _bits(np.asarray(params[k])), k)
    master = to.state_dict()["state"]["master"]["h.0.w"]
    np.testing.assert_allclose(master.numpy(), np.asarray(
        st["master"]["h.0.w"]), rtol=1e-6, atol=1e-7)


def _like(tree):
    if isinstance(tree, dict):
        return {k: _like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_like(v) for v in tree)
    if tree is None:
        return None
    return torch.empty(tuple(torch.as_tensor(tree).shape))


def test_template_load_keeps_the_tree(tmp_path):
    tree = _port_tree(2)
    path = str(tmp_path / "ck")
    tck.save_sharded(tree, path, integrity=_stamp(tfp, tree))
    out = tck.load_sharded(path, _like(tree))
    assert torch.equal(out["model"]["h.0.w"], tree["model"]["h.0.w"])
    assert out["model"]["h.0.w"].dtype == torch.bfloat16
    assert out["optimizer"]["state"]["master"]["h.0.b"] is None
    assert isinstance(out["flags"], list)
    assert int(out["scheduler"]["last_epoch"]) == 2
    # a part of the tree: its digest is not the stamp's, so only without
    # the digest check (as in the JAX package)
    part = tck.load_sharded(path, {"model": _like(tree["model"])},
                            verify_digest=False)
    assert set(part) == {"model"}
    with pytest.raises(tck.DigestMismatch):
        tck.load_sharded(path, {"model": _like(tree["model"])})
    with pytest.raises(Exception, match="shape"):
        tck.load_sharded(path, {"model": {"h.0.b": torch.empty(8)}},
                         verify_digest=False)


def _digest_cases():
    r = np.random.RandomState(3)
    chunk = tfp.CHUNK
    return {
        "f32": r.randn(5, 7).astype(np.float32),
        "f32-chunk": r.randn(chunk).astype(np.float32),
        "f32-chunk+1": r.randn(chunk + 1).astype(np.float32),
        "f32-3chunks": r.randn(3, chunk - 5).astype(np.float32),
        "bf16": np.asarray(jnp.asarray(r.randn(chunk + 9), jnp.bfloat16)),
        "int32": r.randint(-2 ** 31, 2 ** 31 - 1, 77).astype(np.int32),
        "uint8": r.randint(0, 256, 300).astype(np.uint8),
        "bool": r.rand(31) > 0.5,
        "scalar": np.asarray(7, np.int32),
        "empty": np.zeros((0, 3), np.float32),
    }


def _as_torch(x):
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("case", sorted(_digest_cases()))
def test_leaf_digest_matches_jax(case):
    x = _digest_cases()[case]
    want = jfp._leaf_digest_np(x)
    assert tfp._leaf_digest_np(x) == want
    assert tfp._leaf_digest_np(_as_torch(x)) == want
    assert int(tfp._leaf_digest_torch(_as_torch(x))) == want
    if x.dtype != np.bool_ and x.dtype.itemsize >= 2:
        assert int(jfp._leaf_digest_jnp(jnp.asarray(x))) == want


def test_tree_digests_match_across_packages_and_paths():
    cases = _digest_cases()
    tree = {"layer": {k: v for k, v in cases.items()},
            "resid": {"ef_residual": np.ones(3, np.float32)}}
    ttree = {"layer": {k: _as_torch(v) for k, v in cases.items()},
             "resid": {"ef_residual": torch.ones(3)}}
    jhost = jfp.digest_tree_host(tree)
    for fp in (tfp.digest_tree_host(tree), tfp.digest_tree_host(ttree),
               tfp.TreeFingerprint().digest(ttree)):
        assert fp.hex() == jhost.hex()
        assert fp.leaf_digests() == jhost.leaf_digests()
        assert fp.excluded == jhost.excluded == ["resid/ef_residual"]
    assert tfp.tree_digest(tree) == jfp.tree_digest(tree)
    # one flipped bit anywhere moves the digest
    flipped = {k: v.clone() for k, v in ttree["layer"].items()}
    flipped["f32-chunk+1"].view(torch.int32)[-1] ^= 1 << 17
    other = tfp.TreeFingerprint().digest({"layer": flipped,
                                          "resid": ttree["resid"]})
    assert other.hex() != jhost.hex()
    assert other.diff(jhost) == ["layer/f32-chunk+1"]


def _corrupt(path, kind):
    leaf = os.path.join(path, "model__h.0.w", "shard-p0-0.npy")
    manifest = os.path.join(path, "manifest-p0.json")
    if kind == "truncated":
        with open(leaf, "r+b") as f:
            f.truncate(os.path.getsize(leaf) - 1)
    elif kind == "flipped":
        with open(leaf, "r+b") as f:
            f.seek(-3, os.SEEK_END)
            b = f.read(1)
            f.seek(-3, os.SEEK_END)
            f.write(bytes([b[0] ^ 0x10]))
    elif kind == "missing":
        os.remove(leaf)
    elif kind == "torn-manifest":
        with open(manifest, "r+b") as f:
            f.truncate(os.path.getsize(manifest) // 2)


def _write(writer, tree, path, stamp_tree=None):
    stamp_tree = tree if stamp_tree is None else stamp_tree
    if writer == "port":
        tck.save_sharded(tree, path, integrity=_stamp(tfp, stamp_tree))
    else:
        jtree = jax.tree_util.tree_map(
            lambda t: np.asarray(_bits(t)).view(jnp.bfloat16)
            if t.dtype == torch.bfloat16 else t.numpy(), tree)
        jstamp = jax.tree_util.tree_map(
            lambda t: np.asarray(_bits(t)).view(jnp.bfloat16)
            if t.dtype == torch.bfloat16 else t.numpy(), stamp_tree)
        jck.save_sharded(jtree, path, integrity=_stamp(jfp, jstamp))


@pytest.mark.parametrize("kind", ["truncated", "flipped", "missing",
                                  "torn-manifest"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_corruption_raises_in_both_packages(tmp_path, writer, kind):
    tree = {"model": _port_tree(4)["model"]}
    path = str(tmp_path / "ck")
    _write(writer, tree, path)
    _corrupt(path, kind)
    with pytest.raises(tck.CheckpointCorruption):
        tck.load_sharded(path)
    with pytest.raises(jck.CheckpointCorruption):
        jck.load_sharded(path)
    if kind != "torn-manifest":
        assert tck.verify_sharded(path) == jck.verify_sharded(path) != []


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_state_changed_after_stamping_raises_digest_mismatch(tmp_path,
                                                             writer):
    tree = {"model": _port_tree(5)["model"]}
    changed = {"model": dict(tree["model"])}
    changed["model"]["h.0.b"] = tree["model"]["h.0.b"] + 1.0
    path = str(tmp_path / "ck")
    _write(writer, changed, path, stamp_tree=tree)
    with pytest.raises(tck.DigestMismatch, match="h.0.b"):
        tck.load_sharded(path)
    with pytest.raises(jck.DigestMismatch):
        jck.load_sharded(path)
    with pytest.warns(RuntimeWarning):
        out = tck.load_sharded(path, strict=False)
    assert torch.equal(out["model"]["h.0.b"], changed["model"]["h.0.b"])
    assert tck.load_sharded(path, verify_digest=False) is not None


def test_async_save_lands_and_its_error_is_raised(tmp_path, monkeypatch):
    tree = _port_tree(6)
    handle = tck.save_sharded(tree, str(tmp_path / "a"), use_async=True,
                              integrity=_stamp(tfp, tree))
    handle.wait()
    assert handle.done()
    out = tck.load_sharded(str(tmp_path / "a"))
    assert torch.equal(out["model"]["h.0.w"], tree["model"]["h.0.w"])

    def broken(path, payload):
        raise ValueError("disk says no")
    monkeypatch.setattr(tfsio, "write_bytes", broken)
    handle = tck.save_sharded(tree, str(tmp_path / "b"), use_async=True)
    with pytest.raises(ValueError, match="disk says no"):
        handle.wait()
    assert not os.path.exists(str(tmp_path / "b" / "manifest-p0.json"))


def test_transient_write_errors_are_retried(tmp_path, monkeypatch):
    real = tfsio.write_bytes
    fails = {"left": 2}

    def flaky(path, payload):
        if fails["left"]:
            fails["left"] -= 1
            raise OSError("transient")
        real(path, payload)
    monkeypatch.setattr(tfsio, "write_bytes", flaky)
    tree = {"x": torch.arange(5)}
    tck.save_sharded(tree, str(tmp_path / "ck"))
    assert fails["left"] == 0
    assert torch.equal(tck.load_sharded(str(tmp_path / "ck"))["x"],
                       tree["x"])


def test_retry_policy():
    calls = []

    def always():
        calls.append(1)
        raise OSError("down")
    with pytest.raises(RetriesExhausted) as e:
        retry_call(always, policy=SLEEPLESS)
    assert len(calls) == 4 and isinstance(e.value.__cause__, OSError)

    not_io = RetryPolicy(max_attempts=3, retryable=(TimeoutError,),
                         sleep=lambda s: None)
    with pytest.raises(OSError, match="down"):
        retry_call(always, policy=not_io)      # not retryable: at once
    assert calls.count(1) == 5
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)


def _recipe_run(tmp_path, stop_after=None, restore_rng=True):
    """Leg B's recipe at gpt_tiny with dropout 0.1 under recompute: four
    steps straight, or ``stop_after`` steps, a checkpoint, and the rest in
    a fresh model and optimizer loaded from it."""
    from paddle_tpu_torch.convert import init_random_, pretraining_workload
    from paddle_tpu_torch.framework import random as fw_random
    from paddle_tpu_torch.models.gpt import gpt_tiny
    from paddle_tpu_torch.training import train_step
    cfg = gpt_tiny(use_recompute=True, use_pallas_attention=True,
                   dtype="bfloat16")

    def build():
        return pretraining_workload("cpu", cfg, leg="B", batch=2,
                                    seq_len=128)
    fw_random.seed(11)
    model, opt, ids, labels, kw = build()
    losses = [float(train_step(model, opt, ids, labels, **kw))
              for _ in range(stop_after or 4)]
    if stop_after is None:
        return losses
    state = {"model": model.state_dict(), "optimizer": opt.state_dict(),
             "scaler": kw["scaler"].state_dict(),
             "rng": fw_random.get_state()}
    path = str(tmp_path / f"resume-{restore_rng}")
    tck.save_sharded(state, path, integrity=_stamp(tfp, state))
    model, opt, ids, labels, kw = build()
    init_random_(model, 99)
    fw_random.seed(99)
    loaded = tck.load_sharded(path)
    model.load_state_dict(loaded["model"])
    opt.set_state_dict(loaded["optimizer"])
    kw["scaler"].load_state_dict(loaded["scaler"])
    if restore_rng:
        fw_random.set_state(loaded["rng"])
    losses += [float(train_step(model, opt, ids, labels, **kw))
               for _ in range(4 - stop_after)]
    return losses


def test_resume_with_the_random_streams_is_bit_identical(tmp_path):
    straight = _recipe_run(tmp_path)
    assert _recipe_run(tmp_path, stop_after=2) == straight
    # the port's streams are part of the state: without them the resumed
    # steps draw other dropout masks (JAX folds its key per step instead)
    other = _recipe_run(tmp_path, stop_after=2, restore_rng=False)
    assert other[:2] == straight[:2] and other[2:] != straight[2:]
