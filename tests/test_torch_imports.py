"""Import hygiene of the PyTorch/CUDA port: ``paddle_tpu_torch`` and
``chip_smoke.py`` never import JAX or the JAX package."""
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

# an import statement of jax / jaxlib / paddle_tpu (not paddle_tpu_torch)
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|paddle_tpu)(?:\.|\s|,|$)",
    re.MULTILINE)


def _sources():
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_package_imports_with_jax_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['paddle_tpu'] = None\n"
            "import paddle_tpu_torch\n"
            "import paddle_tpu_torch.models.gpt\n"
            "import paddle_tpu_torch.inference.engine\n"
            "import paddle_tpu_torch.ops.fused_block\n"
            "import paddle_tpu_torch.ops.flash_attention\n"
            "import paddle_tpu_torch.ops.fused\n"
            "import paddle_tpu_torch.amp\n"
            "import paddle_tpu_torch.framework.random\n"
            "import paddle_tpu_torch.distributed.mp_ops\n"
            "import paddle_tpu_torch.optimizer\n"
            "import paddle_tpu_torch.training\n"
            "import paddle_tpu_torch.profile_training\n"
            "import paddle_tpu_torch.profile_serving\n"
            "import paddle_tpu_torch.profile_generate\n"
            "import paddle_tpu_torch.inference.kv_cache\n"
            "import paddle_tpu_torch.inference.scheduler\n"
            "import paddle_tpu_torch.inference\n"
            "import paddle_tpu_torch.framework.log\n"
            "import paddle_tpu_torch.utils.fsio\n"
            "import paddle_tpu_torch.observability.registry\n"
            "import paddle_tpu_torch.observability.sinks\n"
            "import paddle_tpu_torch.observability.requesttrace\n"
            "import paddle_tpu_torch.observability.monitor\n"
            "import paddle_tpu_torch.supervisor.watchdog\n"
            "import paddle_tpu_torch.testing.faults\n"
            "import paddle_tpu_torch.inference.fleet\n"
            "import paddle_tpu_torch.inference.fleet.health\n"
            "import paddle_tpu_torch.inference.fleet.journal\n"
            "import paddle_tpu_torch.inference.fleet.router\n"
            "import paddle_tpu_torch.inference.fleet.replica\n"
            "import paddle_tpu_torch.inference.fleet.autoscaler\n"
            "import paddle_tpu_torch.inference.fleet.worker\n"
            "import paddle_tpu_torch.inference.fleet.drills\n"
            "import paddle_tpu_torch.convert\n"
            "import paddle_tpu_torch.regularizer\n"
            "import paddle_tpu_torch.utils.retry\n"
            "import paddle_tpu_torch.optimizer.lr\n"
            "import paddle_tpu_torch.distributed.fleet.recompute\n"
            "import paddle_tpu_torch.distributed.fingerprint\n"
            "import paddle_tpu_torch.distributed.checkpoint\n"
            "import paddle_tpu_torch.models.bert\n"
            "import paddle_tpu_torch.distributed.moe\n"
            "import paddle_tpu_torch.distributed.elastic\n"
            "import paddle_tpu_torch.observability.tracing\n"
            "import paddle_tpu_torch.observability.mfu\n"
            "import paddle_tpu_torch.observability.memory\n"
            "import paddle_tpu_torch.observability.flight\n"
            "import paddle_tpu_torch.metric\n"
            "import paddle_tpu_torch.io\n"
            "import paddle_tpu_torch.framework.io\n"
            "import paddle_tpu_torch.hapi\n"
            "import paddle_tpu_torch.hapi.callbacks\n"
            "import paddle_tpu_torch.hapi.flops\n"
            "import paddle_tpu_torch.hapi.model\n"
            "import paddle_tpu_torch.supervisor\n"
            "import paddle_tpu_torch.supervisor.report\n"
            "import paddle_tpu_torch.supervisor.guard\n"
            "import paddle_tpu_torch.supervisor.heartbeat\n"
            "import paddle_tpu_torch.supervisor.rollback\n"
            "import paddle_tpu_torch.supervisor.integrity\n"
            "import paddle_tpu_torch.utils.tree\n"
            "import paddle_tpu_torch.nn.initializer\n"
            "import paddle_tpu_torch.nn.layers\n"
            "import paddle_tpu_torch.vision\n"
            "import paddle_tpu_torch.vision.transforms\n"
            "import paddle_tpu_torch.vision.datasets\n"
            "import paddle_tpu_torch.vision.models\n"
            "import paddle_tpu_torch.vision.models.lenet\n"
            "import paddle_tpu_torch.vision.models.resnet\n"
            "import paddle_tpu_torch.vision.models.resnext\n"
            "import paddle_tpu_torch.vision.models.utils\n"
            "import paddle_tpu_torch.vision.models.alexnet\n"
            "import paddle_tpu_torch.vision.models.vgg\n"
            "import paddle_tpu_torch.vision.models.squeezenet\n"
            "import paddle_tpu_torch.vision.models.mobilenetv1\n"
            "import paddle_tpu_torch.vision.models.mobilenetv2\n"
            "import paddle_tpu_torch.vision.models.mobilenetv3\n"
            "import paddle_tpu_torch.vision.models.shufflenetv2\n"
            "import paddle_tpu_torch.vision.models.densenet\n"
            "import paddle_tpu_torch.vision.models.googlenet\n"
            "import paddle_tpu_torch.vision.models.inceptionv3\n"
            "import paddle_tpu_torch.vision.ops\n"
            "import paddle_tpu_torch.nn.layers_ext\n"
            "import paddle_tpu_torch.models.translation\n"
            "import paddle_tpu_torch.incubate\n"
            "import paddle_tpu_torch.incubate.nn\n"
            "import paddle_tpu_torch.text\n"
            "import paddle_tpu_torch.text.datasets\n"
            "import paddle_tpu_torch.nn\n"
            "import paddle_tpu_torch.nn.functional\n"
            "import paddle_tpu_torch.nn._functional_ext\n"
            "import paddle_tpu_torch.nn.rnn\n"
            "import paddle_tpu_torch.nn.utils\n"
            "import paddle_tpu_torch.testing.nn_cases\n"
            "import paddle_tpu_torch.nn.layer\n"
            "import paddle_tpu_torch.observability\n"
            "import paddle_tpu_torch.observability.aggregate\n"
            "import paddle_tpu_torch.observability.doctor\n"
            "import paddle_tpu_torch.observability.requesttrace\n"
            "import paddle_tpu_torch.observability.sinks\n"
            "import paddle_tpu_torch.observability.monitor\n"
            "import paddle_tpu_torch.tensor_ops\n"
            "import paddle_tpu_torch.linalg\n"
            "import paddle_tpu_torch.fft\n"
            "import paddle_tpu_torch.signal\n"
            "import paddle_tpu_torch.autograd\n"
            "import paddle_tpu_torch.framework.dtype\n"
            "import paddle_tpu_torch.framework.flags\n"
            "import paddle_tpu_torch.framework.mode\n"
            "import paddle_tpu_torch.framework.debug\n"
            "import paddle_tpu_torch.framework.infermeta\n"
            "import paddle_tpu_torch.framework.tensor_methods\n"
            "import paddle_tpu_torch.incubate.graph_ops\n"
            "import paddle_tpu_torch.ops.spec\n"
            "import paddle_tpu_torch.utils\n"
            "import paddle_tpu_torch.utils.unique_name\n"
            "import paddle_tpu_torch.utils.cpp_extension\n"
            "import paddle_tpu_torch.utils.download\n"
            "import paddle_tpu_torch.version\n"
            "import paddle_tpu_torch.sysconfig\n"
            "import paddle_tpu_torch.callbacks\n"
            "import paddle_tpu_torch.hub\n"
            "import paddle_tpu_torch.reader\n"
            "import paddle_tpu_torch.dataset\n"
            "import paddle_tpu_torch.dataset.mnist\n"
            "import paddle_tpu_torch.dataset.cifar\n"
            "import paddle_tpu_torch.dataset.flowers\n"
            "import paddle_tpu_torch.dataset.imdb\n"
            "import paddle_tpu_torch.dataset.imikolov\n"
            "import paddle_tpu_torch.dataset.uci_housing\n"
            "import paddle_tpu_torch.text.tokenizer\n"
            "import paddle_tpu_torch.io.native\n"
            "import paddle_tpu_torch.distribution\n"
            "import paddle_tpu_torch.sparse\n"
            "import paddle_tpu_torch.incubate.optimizer\n"
            "import paddle_tpu_torch.incubate.sparsity\n"
            "import paddle_tpu_torch.profiler\n"
            "assert 'triton' not in sys.modules\n"
            "loaded = [m for m in sys.modules if sys.modules[m] is not None]\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
            "               for m in loaded)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_top_level_import_pulls_in_the_subpackages():
    # ``import paddle_tpu_torch`` alone gives the paddle namespace: the
    # subpackages the JAX top level imports (those the port has), the
    # Tensor methods, and no JAX, JAX package or Triton
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['paddle_tpu'] = None\n"
            "import paddle_tpu_torch as paddle\n"
            "subs = ['amp', 'autograd', 'framework', 'nn', 'optimizer',\n"
            "        'device', 'fft', 'signal', 'hapi', 'incubate',\n"
            "        'inference', 'io', 'linalg', 'metric', 'observability',\n"
            "        'regularizer', 'utils', 'vision', 'text',\n"
            "        'distribution', 'sparse', 'reader', 'dataset',\n"
            "        'sysconfig', 'callbacks', 'hub', 'profiler', 'version']\n"
            "for s in subs:\n"
            "    assert 'paddle_tpu_torch.' + s in sys.modules, s\n"
            "    assert getattr(paddle, s) is sys.modules[\n"
            "        'paddle_tpu_torch.' + s], s\n"
            "import torch\n"
            "assert torch.Tensor.gather_nd is not None\n"
            "assert paddle.Tensor is torch.Tensor\n"
            "assert 'triton' not in sys.modules\n"
            "loaded = [m for m in sys.modules if sys.modules[m] is not None]\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
            "               or m == 'paddle_tpu' or m.startswith('paddle_tpu.')\n"
            "               for m in loaded)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_or_paddle_tpu_import_in_sources():
    offenders = []
    for path in _sources():
        for m in _FORBIDDEN.finditer(path.read_text()):
            offenders.append(f"{path.relative_to(REPO)}: {m.group(0).strip()}")
    assert not offenders, offenders


def test_scan_pattern():
    # the scan flags the JAX package but not the port's own name
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from paddle_tpu.models import gpt")
    assert _FORBIDDEN.search("    from paddle_tpu import nn")
    assert _FORBIDDEN.search("import paddle_tpu")
    assert not _FORBIDDEN.search("import paddle_tpu_torch")
    assert not _FORBIDDEN.search("from paddle_tpu_torch.models import gpt")
    assert not _FORBIDDEN.search("# see paddle_tpu/ops/fused_block.py")


def test_ops_submodules_are_not_shadowed():
    # the package re-exports the fused ops, never a name of its modules:
    # ``from paddle_tpu_torch.ops import flash_attention`` is the module
    import types
    from paddle_tpu_torch.ops import flash_attention, fused, fused_block
    for module in (flash_attention, fused, fused_block):
        assert isinstance(module, types.ModuleType), module


# names of the JAX ``paddle_tpu.observability`` that the port does not
# export yet, and why: each comes with a later module
_OBSERVABILITY_LEFT_OUT = {
    # compile / retrace tracking and the persistent compile cache track
    # ``jax.jit``; the port has no jit (a tracker of its own is later work)
    "CompileTracker": "compilation", "arg_signature": "compilation",
    "diff_signatures": "compilation", "get_tracker": "compilation",
    "track_jit": "compilation",
    "maybe_enable_persistent_cache": "compilecache",
    "persistent_cache_dir": "compilecache",
    # the roofline observatory parses XLA's compiled HLO; H100 tables
    # come with the port's bench
    "RooflineObservatory": "roofline", "get_observatory": "roofline",
    "capture_window": "roofline", "gap_budget": "roofline",
    "degraded_block": "roofline", "parse_hlo_ops": "roofline",
}


def test_observability_exports_every_ported_jax_name():
    import paddle_tpu.observability as jobs
    import paddle_tpu_torch.observability as tobs
    missing = sorted(set(jobs.__all__) - set(tobs.__all__))
    assert missing == sorted(_OBSERVABILITY_LEFT_OUT), missing
    for name in tobs.__all__:
        assert hasattr(tobs, name), name
