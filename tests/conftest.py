"""Test config: force an 8-device CPU mesh (the analog of the reference's
localhost multi-process distributed tests, SURVEY.md §4) in-process, BEFORE
any test touches a backend — see paddle_tpu.framework.vmesh for why env vars
don't work here."""
from paddle_tpu.framework.vmesh import force_virtual_cpu_mesh

force_virtual_cpu_mesh(8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import jax  # noqa: E402

# numeric-verification tests need exact fp32 matmuls (this XLA CPU build
# defaults to a bf16-ish fast path)
jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture(autouse=True)
def _seed_everything():
    import paddle_tpu as pt
    pt.seed(1234)
    np.random.seed(1234)
    yield


# -- quick tier: `pytest -m quick` runs a <90s cross-section of the suite
# (one file per doctrine row; see tests/README.md for recorded timings)
_QUICK_MODULES = {
    "test_auto_parallel",          # sharding annotations
    "test_fleet_strategy",         # strategy-driven composition
    "test_distribution_extended",  # distributions + datasets
    "test_checkpoint",             # save/load/reshard
    "test_optimizer",              # optimizer family
    "test_launch_multihost",       # 2-process cluster proof
    "test_api_spec",               # API drift guard
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "quick: fast cross-section tier (<90s; see README.md)")
    config.addinivalue_line(
        "markers", "slow: heavyweight tests, deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers", "faults: fault-injection / resilience tests "
        "(tier-1 runs these; budget ~30s on JAX_PLATFORMS=cpu)")
    config.addinivalue_line(
        "markers", "telemetry: observability-layer tests (registry, "
        "tracing, sinks, aggregation; ci.sh runs this tier explicitly)")
    config.addinivalue_line(
        "markers", "serving: paged-KV serving engine tests (KV cache, "
        "scheduler, ragged decode; ci.sh runs this tier explicitly)")
    config.addinivalue_line(
        "markers", "kernels: Pallas kernel / fused-op parity tests "
        "(flash attention, fused block, fused CE; ci.sh runs this tier "
        "explicitly)")
    config.addinivalue_line(
        "markers", "comm: communication-subsystem tests (compressed "
        "collectives, error feedback, ZeRO-1 sharded optimizer; ci.sh "
        "runs this tier explicitly)")
    config.addinivalue_line(
        "markers", "integrity: state-integrity guard tests (tree "
        "fingerprint, desync attribution, replay audit, healing "
        "ladder, checkpoint digest round trip; ci.sh runs this tier "
        "explicitly)")
    config.addinivalue_line(
        "markers", "gpu: PyTorch/CUDA port tests that need a CUDA card "
        "(the kernels have no CPU mode); they skip without one")
    config.addinivalue_line(
        "markers", "ptlint: static-analysis engine tests (pass "
        "fixtures, annotation grammar, baseline workflow, whole-repo "
        "smoke; ci.sh runs this tier explicitly)")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__ in _QUICK_MODULES:
            item.add_marker(pytest.mark.quick)
