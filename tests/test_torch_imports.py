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
            "loaded = [m for m in sys.modules if sys.modules[m] is not None]\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
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
