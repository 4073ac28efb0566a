"""``_kernels.build`` across processes: ranks that start together on one
card compile each library once (a file lock under the build directory)
and load the same ``.so``.  Two processes race on a stub ``nvcc`` (a
script that records its call, waits a second and writes its ``-o``
file)."""
import json
import os
import stat
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STUB = """#!/bin/sh
echo "$$" >> "{calls}"
sleep 1
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
echo stub > "$out"
"""

RACER = (
    "import json\n"
    "from paddle_tpu_torch import _kernels\n"
    "r = _kernels.build(['paged_decode'])\n"
    "print(json.dumps({'compiled': r['compiled'], "
    "'lib': str(_kernels._library('paged_decode'))}))\n")


def test_two_processes_building_together_compile_once(tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    calls = tmp_path / "calls.txt"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(STUB.format(calls=calls))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               PATH=f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}",
               PTPU_COMPILE_CACHE_DIR=str(tmp_path / "build"))
    procs = [subprocess.Popen([sys.executable, "-c", RACER], env=env,
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert sorted(len(o["compiled"]) for o in outs) == [0, 1]
    assert outs[0]["lib"] == outs[1]["lib"]
    assert len(calls.read_text().split()) == 1
    assert os.path.exists(outs[0]["lib"])
    assert not list((tmp_path / "build").glob("*.tmp"))
