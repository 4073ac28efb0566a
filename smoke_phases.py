"""Time each phase of a checkout's ``chip_smoke.py`` on the card.

    python3 smoke_phases.py [CHECKOUT]

Runs ``CHECKOUT/chip_smoke.py`` (this directory by default) in this
process with each of its phase functions wrapped in a wall clock, so that
two commits, the older of which may not log its own ``phase_seconds``,
can be compared phase by phase in one call on one card.  Before the smoke
it times ``import paddle_tpu_torch`` of the checkout in three fresh
processes (after ``import torch``, which is timed on its own), the cost
that every process the smoke starts pays again.  The smoke's output is
passed through; the last line is one JSON object ``{"smoke_phases":
{"checkout", "rc", "seconds", "import_s", "phases": {name: s}}}``.  Needs
what ``chip_smoke.py`` needs: a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

# the functions main() calls for its phases, in its order; a name the
# checkout's smoke lacks is left out
PHASES = ("check_design", "check_stream_design", "check_ln_linear_design",
          "check_tiled_design", "check_kernels", "check_stream",
          "check_ln_linear", "check_tiled", "check_dropout", "check_flash",
          "check_flash_decode", "serve", "serve_lifecycle", "serve_fleet",
          "traced_serving", "train", "train_fused", "check_flash_d128",
          "pretrain", "bert_moe", "supervised_training", "vision",
          "translation", "vision_zoo", "nn_rest", "tensor_api", "generate")

IMPORT_PROBE = ("import time; t0 = time.perf_counter(); import torch; "
                "t1 = time.perf_counter(); import paddle_tpu_torch; "
                "t2 = time.perf_counter(); print(t1 - t0, t2 - t1)")


def import_seconds(checkout: str, reps: int = 3) -> dict:
    torch_s, package_s = [], []
    for _ in range(reps):
        out = subprocess.run([sys.executable, "-c", IMPORT_PROBE],
                             cwd=checkout, capture_output=True, text=True,
                             check=True, timeout=300).stdout.split()
        torch_s.append(float(out[0]))
        package_s.append(float(out[1]))
    return {"torch": torch_s, "paddle_tpu_torch": package_s}


def main() -> int:
    checkout = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                               os.path.dirname(os.path.abspath(__file__)))
    imports = import_seconds(checkout)
    os.chdir(checkout)
    sys.path.insert(0, checkout)
    sys.argv = [os.path.join(checkout, "chip_smoke.py")]
    import chip_smoke
    phases = {}

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                phases[name] = phases.get(name, 0.0) + \
                    time.perf_counter() - t0
        return run

    for name in PHASES:
        if hasattr(chip_smoke, name):
            setattr(chip_smoke, name, timed(name, getattr(chip_smoke, name)))
    t0 = time.perf_counter()
    try:
        rc = chip_smoke.main()
    except Exception as e:          # noqa: BLE001 (reported, rc 1)
        print(f"smoke_phases: the smoke raised {type(e).__name__}: {e}",
              flush=True)
        rc = 1
    seconds = time.perf_counter() - t0
    phases["rest"] = seconds - sum(phases.values())
    print(json.dumps({"smoke_phases": {
        "checkout": checkout, "rc": rc, "seconds": seconds,
        "import_s": imports, "phases": phases}}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
