"""Hybrid parallelism of the port (dp x mp x pp over ``torch.distributed``)
against the JAX package on its 8-device CPU mesh, from the same numpy
weights and batch (gpt_tiny, float32, dropout 0).

Three process worlds run the rank side (``paddle_tpu_torch/testing/
hybrid_cases.py``) over gloo, one intra-op thread a rank, all started
together when the module's first world test asks for one:

- 2 ranks by ``python -m paddle_tpu_torch.distributed.launch
  --nproc_per_node 2``: pp = 2 with 4 micro-batches (the launcher's
  environment, a 2-rank all-reduce, every collective over the pp axis,
  one GPT step against ``GPTPipeline``);
- 4 ranks by ``distributed.spawn``: dp = 2 x mp = 2 (a 2-rank all-reduce
  on each dp group, the mp layers, the vocab-parallel ops, the RNG
  tracker, ``DataParallel``, the engine's refusal, one GPT step against
  ``fleet`` dp2 x mp2);
- 8 ranks by ``launch``: dp2 x mp2 x pp2, 4 micro-batches (one GPT step
  against the ``dryrun_multichip`` layout).

Each check is a test of its own over the module's worlds.  Tolerances:
losses and the global norm rtol 1e-5; gradients within 1e-5 of their
parameter's largest JAX gradient (rtol 1e-5); an updated parameter within
rtol 1e-5 / atol 1e-7 wherever the JAX gradient is above 1e-4 of the
largest gradient anywhere (below it Adam's normalised step turns rounding
noise into up to +-lr: the k bias of qkv, whose gradient is zero in
exact arithmetic, is the case; those elements are held by the gradient
check alone).
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as pt
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.sequence_parallel import shard_map

import torch

import paddle_tpu_torch.distributed as tdist_port
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.framework.errors import (UnavailableError,
                                               UnimplementedError)

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device CPU mesh")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(hidden_size=128, num_layers=2, num_heads=4,
           max_position_embeddings=256, vocab_size=1024, hidden_dropout=0.0,
           attention_dropout=0.0)
OPT = {"lr": 1e-3, "wd": 0.01, "clip": 1.0}
B, S, MICRO = 8, 128, 4
LAYOUTS = {2: {"dp": 1, "mp": 1, "pp": 2, "micro": MICRO},
           4: {"dp": 2, "mp": 2, "pp": 1, "micro": 1},
           8: {"dp": 2, "mp": 2, "pp": 2, "micro": MICRO}}
JOBS = {2: ["env", "allreduce", "collectives", "gpt_step"],
        4: ["allreduce", "mp_layers", "mp_ops", "tracker", "dataparallel",
            "engine_refuses", "recompute_dropout", "gpt_step"],
        8: ["gpt_step"]}
WORLD_TIMEOUT = 600


@pytest.fixture(autouse=True)
def _reset_groups():
    """Hybrid-group hygiene: no JAX mesh and no port group outlives a
    test (a leaked JAX mesh makes later JAX engines refuse to run)."""
    yield
    jdist.set_hybrid_communicate_group(None)
    jdist.get_rng_state_tracker().reset()
    tdist_port.set_hybrid_communicate_group(None)
    tdist_port.get_rng_state_tracker().reset()


def _arrays():
    """The shared inputs: the JAX gpt_tiny's numpy state, the global batch
    and the small jobs' arrays, all seeded."""
    from paddle_tpu.models import GPTConfig, GPTForCausalLM
    pt.seed(3)
    state = {k: np.asarray(v) for k, v in
             GPTForCausalLM(GPTConfig(**CFG)).state_dict().items()}
    rng = np.random.RandomState(0)
    out = {f"state/{k}": v for k, v in state.items()}
    out.update(
        ids=rng.randint(0, 1024, (B, S)).astype(np.int64),
        labels=rng.randint(0, 1024, (B, S)).astype(np.int64),
        coll_x=rng.randn(2, 4, 6).astype(np.float32),
        mlp_x=rng.randn(4, 16).astype(np.float32),
        mlp_w1=(0.2 * rng.randn(16, 32)).astype(np.float32),
        mlp_b1=(0.1 * rng.randn(32)).astype(np.float32),
        mlp_w2=(0.2 * rng.randn(32, 16)).astype(np.float32),
        mlp_b2=(0.1 * rng.randn(16)).astype(np.float32),
        mlp_cot=rng.randn(4, 16).astype(np.float32),
        emb_table=rng.randn(16, 8).astype(np.float32),
        emb_ids=np.array([0, 3, 7, 8, 12, 15], np.int64),
        emb_cot=rng.randn(6, 8).astype(np.float32),
        ce_logits=(3 * rng.randn(6, 16)).astype(np.float32),
        ce_labels=np.array([1, 9, -100, 15, 8, 0], np.int64),
        dp_w=rng.randn(2, 4).astype(np.float32),
        dp_x=rng.randn(4, 3, 4).astype(np.float32))
    return out


class _World:
    """One process world of the rank side, started at once."""

    def __init__(self, n, base, data_path, launcher):
        self.n = n
        self.out = os.path.join(base, f"world{n}")
        os.makedirs(self.out)
        spec = {"out": self.out, "data": data_path, "layout": LAYOUTS[n],
                "jobs": JOBS[n], "cfg": {**CFG, "use_pallas_attention": True},
                "opt": OPT, "axis": "pp"}
        spec_path = os.path.join(self.out, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        self.log = open(os.path.join(self.out, "log.txt"), "w")
        if launcher == "launch":
            cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
                   "--nproc_per_node", str(n),
                   os.path.join(REPO, "paddle_tpu_torch", "testing",
                                "hybrid_cases.py"), spec_path]
        else:
            cmd = [sys.executable, "-c",
                   "import json, sys\n"
                   "from paddle_tpu_torch.distributed import spawn\n"
                   "from paddle_tpu_torch.testing import hybrid_cases\n"
                   f"spec = json.load(open({spec_path!r}))\n"
                   f"spawn(hybrid_cases.rank_main, (spec,), nprocs={n})\n"]
        self.proc = subprocess.Popen(cmd, env=env, cwd=REPO,
                                     stdout=self.log,
                                     stderr=subprocess.STDOUT)
        self._results = None

    def results(self):
        if self._results is None:
            try:
                rc = self.proc.wait(timeout=WORLD_TIMEOUT)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                rc = "timeout"
            self.log.close()
            with open(self.log.name) as f:
                text = f.read()
            assert rc == 0, f"world of {self.n} failed ({rc}):\n{text[-4000:]}"
            self._results = []
            for r in range(self.n):
                with open(os.path.join(self.out, f"rank{r}.pkl"), "rb") as f:
                    self._results.append(pickle.load(f))
        return self._results


@pytest.fixture(scope="module")
def arrays():
    return _arrays()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, arrays):
    base = str(tmp_path_factory.mktemp("hybrid"))
    data_path = os.path.join(base, "data.npz")
    np.savez(data_path, **arrays)
    ws = {2: _World(2, base, data_path, "launch"),
          4: _World(4, base, data_path, "spawn"),
          8: _World(8, base, data_path, "launch")}
    yield ws
    for w in ws.values():
        if w.proc.poll() is None:
            w.proc.kill()
            w.proc.wait()


# the JAX references depend on ``worlds`` so that the worlds start first
# and run while the references are computed


def _by_coord(results, job="gpt_step"):
    return {(r[job]["coord"]["dp"], r[job]["coord"]["pp"],
             r[job]["coord"]["mp"]): r[job] for r in results}


# ---------------------------------------------------------------------------
# The topology, in process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("names,dims", [
    (("data", "pipe", "sharding", "model"), (2, 2, 1, 2)),
    (("data", "pipe", "sharding", "model"), (1, 2, 1, 4)),
    (("data", "pipe", "model"), (2, 2, 2)),
    (("data", "model"), (4, 2))])
def test_topology_coordinates_and_rank_lists_are_the_jax_ones(names, dims):
    from paddle_tpu_torch.distributed.topology import CommunicateTopology
    ref = jdist.CommunicateTopology(list(names), list(dims))
    got = CommunicateTopology(names, dims)
    assert got.world_size() == ref.world_size()
    for r in range(ref.world_size()):
        assert got.get_coord(r) == ref.get_coord(r)
        assert got.get_rank(**dict(zip(names, ref.get_coord(r)))) == r
    for name in names:
        assert got.get_comm_list(name) == ref.get_comm_list(name)
        for i in range(ref.get_dim(name)):
            assert got.get_axis_list(name, i) == ref.get_axis_list(name, i)


# ---------------------------------------------------------------------------
# The launcher, spawn, the collectives
# ---------------------------------------------------------------------------
def test_launch_wires_the_rank_environment(worlds, jax_steps, jax_collectives,
                                          jax_mp_layers, jax_mp_ops):
    # the JAX references are computed (above) while the worlds run
    res = worlds[2].results()
    for r, out in enumerate(res):
        job = out["env"]
        env = job["env"]
        assert job["rank"] == r and job["world"] == 2
        assert job["backend"] == "gloo" and job["threads"] == 1
        assert env["PADDLE_TRAINER_ID"] == env["RANK"] == str(r)
        assert env["PADDLE_TRAINERS_NUM"] == env["WORLD_SIZE"] == "2"
        eps = env["PADDLE_TRAINER_ENDPOINTS"].split(",")
        assert len(eps) == 2 and env["PADDLE_CURRENT_ENDPOINT"] == eps[r]
        assert env["PADDLE_MASTER"] == eps[0]


@pytest.mark.parametrize("n", [2, 4])
def test_two_rank_all_reduce(worlds, n):
    """``launch``'s 2 ranks over the world, ``spawn``'s over each dp
    group of 2."""
    res = worlds[n].results()
    for r, out in enumerate(res):
        group = out["allreduce"]["dp_ranks"] if n == 4 else [0, 1]
        want = sum(np.array([g + 1.0, 2.0 * (g + 1)]) for g in group)
        np.testing.assert_array_equal(
            out["allreduce"]["dp" if n == 4 else "world"], want)
        assert len(group) == 2


COLLECTIVES = ["sum", "max", "min", "prod", "avg", "all_gather",
               "all_gather_stacked", "reduce_scatter", "broadcast", "reduce",
               "scatter", "all_to_all", "permute", "p2p_push", "split"]


def _jax_collectives(x):
    """Each collective of the JAX package inside shard_map over a
    2-device "pp" axis: the per-device outputs."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("pp",))
    R = jdist.ReduceOp
    fns = {
        "sum": lambda v: jdist.all_reduce(v, R.SUM, "pp"),
        "max": lambda v: jdist.all_reduce(v, R.MAX, "pp"),
        "min": lambda v: jdist.all_reduce(v, R.MIN, "pp"),
        "prod": lambda v: jdist.all_reduce(jnp.abs(v) + 0.5, R.PROD, "pp"),
        "avg": lambda v: jdist.all_reduce(v, R.AVG, "pp"),
        "all_gather": lambda v: jdist.all_gather(v, "pp", axis=1),
        "all_gather_stacked": lambda v: jdist.all_gather(v, "pp", axis=0,
                                                         tiled=False),
        "reduce_scatter": lambda v: jdist.reduce_scatter(v, R.SUM, "pp",
                                                         axis=0),
        "broadcast": lambda v: jdist.broadcast(v, 1, "pp"),
        "reduce": lambda v: jdist.reduce(v, 1, R.SUM, "pp"),
        "scatter": lambda v: jdist.scatter(v, 0, "pp", axis=0),
        "all_to_all": lambda v: jdist.all_to_all(v, "pp", split_axis=0,
                                                 concat_axis=1),
        "permute": lambda v: jdist.send_recv_permute(v, [(0, 1)], "pp"),
        "p2p_push": lambda v: jdist.p2p_push(v, 1, "pp"),
        "split": lambda v: jdist.split(v, "pp", axis=-1),
    }
    out = {}
    for name, fn in fns.items():
        f = shard_map(fn, mesh=mesh, in_specs=(P("pp"),), out_specs=P("pp"))
        y = np.asarray(f(jnp.asarray(x.reshape(-1, x.shape[-1]))))
        out[name] = np.split(y, 2, axis=0)
    return out


@pytest.fixture(scope="module")
def jax_collectives(arrays, worlds):
    return _jax_collectives(arrays["coll_x"])


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_matches_jax(worlds, jax_collectives, name):
    for out in worlds[2].results():
        got = out["collectives"][name]
        want = jax_collectives[name][out["collectives"]["index"]]
        want = want.reshape(got.shape)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_gloo_on_the_cpu_stages_nothing(worlds):
    """Host staging is for card tensors under gloo only."""
    for n in (2, 4, 8):
        assert all(r["gpt_step"]["staged"] == 0 for r in worlds[n].results())


# ---------------------------------------------------------------------------
# The mp layers, the vocab-parallel ops, the tracker, DataParallel
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_mp_layers(arrays, worlds):
    import paddle_tpu.nn as jnn
    import paddle_tpu.nn.functional as JF
    a = arrays

    class MLP(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = jdist.ColumnParallelLinear(16, 32, gather_output=False)
            self.fc2 = jdist.RowParallelLinear(32, 16, input_is_parallel=True)

        def forward(self, x):
            return self.fc2(JF.gelu(self.fc1(x)))

    try:
        strategy = jfleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
        jfleet.init(strategy=strategy)
        mlp, emb = MLP(), jdist.VocabParallelEmbedding(16, 8)
        v = {"fc1.weight": a["mlp_w1"], "fc1.bias": a["mlp_b1"],
             "fc2.weight": a["mlp_w2"], "fc2.bias": a["mlp_b2"]}
        v = {k: jnp.asarray(x) for k, x in v.items()}

        def mlp_loss(v, x):
            y = mlp.apply(v, x)
            return jnp.sum(y * a["mlp_cot"]), y
        (_, y), (dv, dx) = jax.jit(jax.value_and_grad(
            mlp_loss, argnums=(0, 1), has_aux=True))(v, jnp.asarray(a["mlp_x"]))

        def emb_loss(t):
            e = emb.apply({"weight": t}, jnp.asarray(a["emb_ids"]))
            return jnp.sum(e * a["emb_cot"]), e
        (_, e), dt = jax.jit(jax.value_and_grad(emb_loss, has_aux=True))(
            jnp.asarray(a["emb_table"]))
    finally:
        jdist.set_hybrid_communicate_group(None)
    return {"y": np.asarray(y), "dx": np.asarray(dx),
            "dw1": np.asarray(dv["fc1.weight"]),
            "db1": np.asarray(dv["fc1.bias"]),
            "dw2": np.asarray(dv["fc2.weight"]),
            "db2": np.asarray(dv["fc2.bias"]),
            "emb_y": np.asarray(e), "emb_dtable": np.asarray(dt)}


# the mp shard axis of each gradient (None: whole on every rank)
_MLP_AXES = {"y": None, "dx": None, "dw1": 1, "db1": 0, "dw2": 0,
             "db2": None}


@pytest.mark.parametrize("form", ["parallel", "gathered"])
def test_mp_layers_forward_and_backward_match_jax(worlds, jax_mp_layers,
                                                  form):
    for out in worlds[4].results():
        got, r = out["mp_layers"][form], out["mp_layers"]["mp_rank"]
        for key, axis in _MLP_AXES.items():
            want = jax_mp_layers[key]
            if axis is not None:
                want = np.array_split(want, 2, axis=axis)[r]
            np.testing.assert_allclose(got[key], want, rtol=2e-5, atol=2e-6,
                                       err_msg=f"{form} {key}")


def test_vocab_parallel_embedding_layer_matches_jax(worlds, jax_mp_layers):
    for out in worlds[4].results():
        got, r = out["mp_layers"]["embedding"], out["mp_layers"]["mp_rank"]
        np.testing.assert_allclose(got["y"], jax_mp_layers["emb_y"],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            got["dtable"],
            np.array_split(jax_mp_layers["emb_dtable"], 2, axis=0)[r],
            rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def jax_mp_ops(arrays, worlds):
    a = arrays
    mesh = Mesh(np.array(jax.devices()[:2]), ("mp",))
    logits = jnp.asarray(a["ce_logits"])
    labels = jnp.asarray(a["ce_labels"])

    def per_device(fn, in_specs, out_spec, *args):
        f = shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_spec)
        return np.asarray(f(*args))

    none = per_device(
        lambda lg, lb: jdist.parallel_cross_entropy(lg, lb)[None],
        (P(None, "mp"), P(None)), P("mp"), logits, labels)
    mean = per_device(
        lambda lg, lb: jdist.parallel_cross_entropy(
            lg, lb, reduction="mean")[None],
        (P(None, "mp"), P(None)), P("mp"), logits, labels)
    logsm = per_device(lambda lg: jdist.parallel_log_softmax(lg),
                       (P(None, "mp"),), P(None, "mp"), logits)
    emb = per_device(
        lambda t, i: jdist.vocab_parallel_embedding(i, t, mp_axis="mp")[None],
        (P("mp", None), P(None)), P("mp"), jnp.asarray(a["emb_table"]),
        jnp.asarray(a["emb_ids"]))
    dlogits = np.asarray(jax.grad(lambda lg: jdist.parallel_cross_entropy(
        lg, labels, reduction="mean"))(logits))
    return {"none": none, "mean": mean, "log_softmax": logsm,
            "embedding": emb, "dlogits": dlogits}


@pytest.mark.parametrize("op", ["none", "mean", "dlogits", "log_softmax",
                                "embedding"])
def test_vocab_parallel_ops_match_jax(worlds, jax_mp_ops, op):
    for out in worlds[4].results():
        got, r = out["mp_ops"][op], out["mp_ops"]["mp_rank"]
        want = jax_mp_ops[op]
        if op in ("none", "mean", "embedding"):
            want = want[r]
        elif op in ("dlogits", "log_softmax"):
            want = np.array_split(want, 2, axis=-1)[r]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_tracker_masks_differ_per_mp_rank_and_agree_in_the_global_stream(
        worlds):
    res = [r["tracker"] for r in worlds[4].results()]
    for a in res:
        for b in res:
            if a is b or a["coord"]["dp"] != b["coord"]["dp"]:
                continue
            # the mp ranks of one replica: distinct model-parallel draws,
            # equal global ones
            assert not np.array_equal(a["local"], b["local"])
            assert a["local_seed"] != b["local_seed"]
            np.testing.assert_array_equal(a["global"], b["global"])
            assert a["global_seed"] == b["global_seed"]


def test_recompute_replays_the_model_parallel_dropout_masks(worlds):
    """Dropout 0.1 under mp: a recomputed block draws the forward's masks
    (the default and the model-parallel streams), so the gradients are the
    plain run's bit for bit, on every rank."""
    no_dropout = worlds[4].results()[0]["gpt_step"]
    for out in worlds[4].results():
        job = out["recompute_dropout"]
        assert job["plain"]["loss"] == job["recompute"]["loss"]
        for k, g in job["plain"]["grads"].items():
            np.testing.assert_array_equal(job["recompute"]["grads"][k], g,
                                          err_msg=k)
        assert job["plain"]["loss"] != no_dropout["loss"]


def test_dataparallel_averages_over_the_dp_group_only(worlds, arrays):
    res = worlds[4].results()
    dp_groups = [r["allreduce"]["dp_ranks"] for r in res]
    for r, out in enumerate(res):
        group = dp_groups[r]
        want = np.mean([res[g]["dataparallel"]["local"] for g in group],
                       axis=0)
        np.testing.assert_allclose(out["dataparallel"]["synced"], want,
                                   rtol=1e-6, atol=1e-7)
        assert not np.allclose(out["dataparallel"]["local"], want)


def test_serving_engine_refuses_a_hybrid_group(worlds):
    for out in worlds[4].results():
        assert "hybrid group" in out["engine_refuses"]


# ---------------------------------------------------------------------------
# One GPT step in each layout, against the JAX package
# ---------------------------------------------------------------------------
def _jax_step(arrays, layout):
    """Loss, grads and updated params of one JAX AdamW step with the
    global-norm clip in ``layout`` (GSPMD for dp x mp, ``GPTPipeline``'s
    1F1B with pp)."""
    from paddle_tpu.models import GPTConfig, GPTForCausalLM
    state = {k[6:]: jnp.asarray(v) for k, v in arrays.items()
             if k.startswith("state/")}
    try:
        strategy = jfleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": layout["dp"],
                                   "mp_degree": layout["mp"],
                                   "pp_degree": layout["pp"]}
        strategy.pipeline_configs = {"accumulate_steps": layout["micro"]}
        jfleet.init(is_collective=True, strategy=strategy)
        pt.seed(3)
        model = GPTForCausalLM(GPTConfig(**CFG))
        model.train()
        opt = pt.optimizer.AdamW(
            learning_rate=OPT["lr"], weight_decay=OPT["wd"],
            grad_clip=pt.optimizer.ClipGradByGlobalNorm(OPT["clip"]))
        ids = jdist.shard_batch(arrays["ids"].astype(np.int32))
        labels = jdist.shard_batch(arrays["labels"].astype(np.int32))
        if layout["pp"] > 1:
            pipe = jfleet.distributed_model(model)
            st = pipe.place_state(pipe.split_state(state))
            loss, grads = jax.jit(pipe.loss_and_grads)(
                st, ids, labels, jax.random.key(0))
            new, _ = jax.jit(opt.apply_gradients)(grads, st, opt.init(st))
            grads, new = pipe.merge_state(grads), pipe.merge_state(new)
        else:
            jfleet.distributed_model(model)
            shardings = jdist.variables_sharding(model)
            st = {k: jax.device_put(v, shardings[k]) for k, v in state.items()}

            def loss_fn(p):
                return model.apply(p, ids, labels=labels)[0]
            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(st)
            new, _ = jax.jit(opt.apply_gradients)(grads, st, opt.init(st))
    finally:
        jdist.set_hybrid_communicate_group(None)
    grads = {k: np.asarray(v) for k, v in grads.items()}
    norm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                             for g in grads.values())))
    return {"loss": float(loss), "norm": norm, "grads": grads,
            "params": {k: np.asarray(v) for k, v in new.items()}}


@pytest.fixture(scope="module")
def jax_steps(arrays, worlds):
    return {n: _jax_step(arrays, LAYOUTS[n]) for n in (2, 4, 8)}


def _replica(results, dp):
    from paddle_tpu_torch import convert
    steps = _by_coord(results)
    grads = convert.gather_state({(p, m): s["grads"] for (d, p, m), s
                                  in steps.items() if d == dp})
    params = convert.gather_state({(p, m): s["params"] for (d, p, m), s
                                   in steps.items() if d == dp})
    return steps, grads, params


STEP_WORLDS = [pytest.param(2, id="pp2"), pytest.param(4, id="dp2xmp2"),
               pytest.param(8, id="dp2xmp2xpp2")]


@pytest.mark.parametrize("n", STEP_WORLDS)
def test_gpt_step_loss_and_norm_match_jax(worlds, jax_steps, n):
    want = jax_steps[n]
    for out in worlds[n].results():
        np.testing.assert_allclose(out["gpt_step"]["loss"], want["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(out["gpt_step"]["norm"], want["norm"],
                                   rtol=1e-5)


@pytest.mark.parametrize("n", STEP_WORLDS)
def test_gpt_step_gradients_match_jax(worlds, jax_steps, n):
    want = jax_steps[n]["grads"]
    for dp in range(LAYOUTS[n]["dp"]):
        _, grads, _ = _replica(worlds[n].results(), dp)
        assert sorted(grads) == sorted(want)
        for k, g in want.items():
            np.testing.assert_allclose(
                grads[k], g, rtol=1e-5, atol=1e-5 * np.abs(g).max(),
                err_msg=k)


@pytest.mark.parametrize("n", STEP_WORLDS)
def test_gpt_step_updated_parameters_match_jax(worlds, jax_steps, n):
    ref = jax_steps[n]
    floor = 1e-4 * max(np.abs(g).max() for g in ref["grads"].values())
    replicas = [_replica(worlds[n].results(), dp)[2]
                for dp in range(LAYOUTS[n]["dp"])]
    for params in replicas[1:]:             # dp replicas stay equal
        for k in params:
            np.testing.assert_array_equal(params[k], replicas[0][k])
    for k, want in ref["params"].items():
        sure = np.abs(ref["grads"][k]) > floor
        np.testing.assert_allclose(replicas[0][k][sure], want[sure],
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("n", [2, 8])
def test_pipeline_stages_hold_their_share_and_the_tied_table(worlds, n):
    """Stage 0 holds wte, wpe and its layers, the last stage its layers,
    ln_f and wte; both copies of the tied wte take the same update."""
    steps = _by_coord(worlds[n].results())
    for (d, p, m), s in steps.items():
        keys = set(s["params"])
        assert ("gpt.wpe" in keys) == (p == 0)
        assert ("gpt.ln_f.weight" in keys) == (p == 1)
        assert "gpt.wte.weight" in keys
        assert {k.split(".")[2] for k in keys if k.startswith("gpt.h.")} \
            == {str(p)}
        if p == 1:
            np.testing.assert_array_equal(
                s["params"]["gpt.wte.weight"],
                steps[(d, 0, m)]["params"]["gpt.wte.weight"])


# ---------------------------------------------------------------------------
# HybridParallelOptimizer and the refusals, in process
# ---------------------------------------------------------------------------
def _hpo(**flags):
    from paddle_tpu_torch.distributed.fleet.optimizer import (
        HybridParallelOptimizer)
    from paddle_tpu_torch.optimizer import SGD
    strategy = tfleet.DistributedStrategy()
    for k, v in flags.items():
        setattr(strategy, k, v)
    w = torch.nn.Parameter(torch.ones(4))
    return w, strategy, lambda lr_: HybridParallelOptimizer(
        SGD(learning_rate=lr_, parameters=[("w", w)]), strategy)


def test_hybrid_optimizer_fp16_scaler_skips_nonfinite_and_decays_scale():
    """test_fleet_strategy.py's amp case, in both packages."""
    from paddle_tpu.distributed.fleet.optimizer import (
        HybridParallelOptimizer as JHPO)
    w, strategy, make = _hpo(amp=True)
    strategy.amp_configs = {"dtype": "float16", "init_loss_scaling": 1024.0,
                            "decr_every_n_nan_or_inf": 1}
    o = make(0.1)
    assert o.scaler.is_enable()
    assert float(o.scale_loss(torch.tensor(2.0))) == 2048.0
    w.grad = torch.full((4,), 1024.0)
    o.step()
    np.testing.assert_allclose(w.detach().numpy(), 0.9, rtol=1e-7)
    w.grad = torch.tensor([float("inf"), 1.0, 1.0, 1.0])
    o.step()
    np.testing.assert_allclose(w.detach().numpy(), 0.9, rtol=1e-7)
    assert float(o.scaler._st["scale"]) == 512.0
    assert int(o.inner._step) == 1
    # the JAX wrapper on the same gradients
    js = jfleet.DistributedStrategy()
    js.amp = True
    js.amp_configs = dict(strategy.amp_configs)
    jo = JHPO(pt.optimizer.SGD(learning_rate=0.1), js)
    p = {"w": jnp.ones((4,), jnp.float32)}
    st = jo.init(p)
    p, st = jo.apply_gradients({"w": jnp.full((4,), 1024.0)}, p, st)
    p, st = jo.apply_gradients({"w": jnp.asarray([np.inf, 1, 1, 1],
                                                 jnp.float32)}, p, st)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(p["w"]),
                               rtol=1e-7)
    assert float(st["amp"]["scale"]) == float(o.scaler._st["scale"])


def test_hybrid_optimizer_gradient_merge_matches_the_mean_gradient():
    """test_fleet_strategy.py's gradient_merge case (k = 3, avg)."""
    w, strategy, make = _hpo(gradient_merge=True)
    strategy.gradient_merge_configs = {"k_steps": 3, "avg": True}
    o = make(0.5)
    for i in range(3):
        w.grad = torch.full((4,), float(i + 1))
        o.step()
        if i < 2:
            np.testing.assert_array_equal(w.detach().numpy(), 1.0)
    np.testing.assert_allclose(w.detach().numpy(), 1.0 - 0.5 * 2.0,
                               rtol=1e-7)
    assert int(o.inner._step) == 1 and o.gm_step == 0


def test_init_parallel_env_refuses_more_ranks_than_cards(monkeypatch):
    from paddle_tpu_torch.distributed import parallel
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.delenv("PADDLE_LOCAL_SIZE", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(UnavailableError, match="backend='gloo'"):
        parallel.init_parallel_env()
    assert parallel.backend_for(2, 2, "gloo") == "gloo"


@pytest.mark.parametrize("flag", ["sharding", "sp_degree", "ep_degree",
                                  "comm_configs"])
def test_unported_strategy_flags_raise_naming_the_roadmap(flag):
    strategy = tfleet.DistributedStrategy()
    if flag == "sharding":
        strategy.sharding = True
    elif flag == "comm_configs":
        strategy.comm_configs = {"dtype": "int8"}
    else:
        strategy.hybrid_configs = {**strategy.hybrid_configs, flag: 2}
    with pytest.raises(UnimplementedError, match="ROADMAP.md"):
        tfleet.init(is_collective=True, strategy=strategy)


def test_quantized_all_reduce_raises_naming_the_roadmap():
    with pytest.raises(UnimplementedError, match="ROADMAP.md"):
        tdist_port.all_reduce_quantized(torch.ones(4))


def test_collectives_are_the_identity_without_a_group():
    x = torch.arange(6.0).reshape(2, 3)
    for fn in (tdist_port.all_reduce, tdist_port.broadcast,
               tdist_port.split, tdist_port.all_gather):
        assert fn(x) is x


def test_fleet_import_paths_and_facade_in_one_process():
    """test_fleet_strategy.py's import-path and facade cases, in the port
    (one process: the collectives are the identity)."""
    from paddle_tpu_torch.distributed import mp_layers, random as trandom
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, PipelineParallel, RowParallelLinear,
        VocabParallelEmbedding, get_rng_state_tracker)
    from paddle_tpu_torch.distributed.fleet.utils import (
        fused_allreduce_gradients, recompute)
    from paddle_tpu_torch.models.gpt_pipeline import GPTPipeline
    assert ColumnParallelLinear is mp_layers.ColumnParallelLinear
    assert RowParallelLinear is mp_layers.RowParallelLinear
    assert VocabParallelEmbedding is mp_layers.VocabParallelEmbedding
    assert get_rng_state_tracker is trandom.get_rng_state_tracker
    assert PipelineParallel is GPTPipeline and callable(recompute)
    assert fused_allreduce_gradients([], None) is None
    f = tfleet.Fleet()
    assert f.worker_index() == 0 and f.worker_num() == 1
    assert f.util.get_file_shard(["a", "b", "c"]) == ["a", "b", "c"]
    assert [x.tolist() for x in f.util.all_gather([1, 2])] == [[1, 2]]
    assert tfleet.PaddleCloudRoleMaker().is_first_worker()
