"""``python -m paddle_tpu_torch.distributed.launch``: the port of
``paddle_tpu/distributed/launch`` (the reference's collective controller,
launch/controllers/collective.py:89-92).

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 8 \\
        train.py --lr 1e-4

starts one process per rank on this host (``--nnodes`` hosts of
``--nproc_per_node`` ranks; ``--node_rank`` names this host), each with
``rank_env``: ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``,
``PADDLE_MASTER``, ``PADDLE_LOCAL_RANK`` / ``PADDLE_LOCAL_SIZE``, and
torch's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``; ``OMP_NUM_THREADS`` is 1 unless set.
The script calls ``init_parallel_env`` (or ``fleet.init``), which reads
them (:func:`init_from_env` is that call).  The master's port, unless
``--master`` names one, is a free one the OS picks.  When a rank fails the
launcher stops the others and exits with its code; a SIGTERM to the
launcher stops every rank.
"""
from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

__all__ = ["init_from_env", "launch", "rank_env", "free_port"]


def free_port() -> int:
    """A TCP port on the loopback interface that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return int(s.getsockname()[1])


def rank_env(rank: int, world: int, master: str, local_rank: Optional[int]
             = None, local_size: Optional[int] = None) -> Dict[str, str]:
    """The environment contract of one rank (``master`` is host:port of
    rank 0; rank ``i``'s endpoint is the master's host at port + i)."""
    host, port = master.rsplit(":", 1)
    local_rank = rank if local_rank is None else local_rank
    local_size = world if local_size is None else local_size
    endpoints = [f"{host}:{int(port) + i}" for i in range(world)]
    return {
        "PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
        "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
        "PADDLE_MASTER": master, "PADDLE_LOCAL_RANK": str(local_rank),
        "PADDLE_LOCAL_SIZE": str(local_size),
        "RANK": str(rank), "WORLD_SIZE": str(world),
        "LOCAL_RANK": str(local_rank), "LOCAL_WORLD_SIZE": str(local_size),
        "MASTER_ADDR": host, "MASTER_PORT": str(port)}


def init_from_env(backend: Optional[str] = None):
    """Join the process group the launcher's environment names
    (``init_parallel_env``)."""
    from ..parallel import init_parallel_env
    return init_parallel_env(backend=backend)


def launch(argv: Optional[List[str]] = None) -> int:
    """Entry of ``python -m paddle_tpu_torch.distributed.launch``."""
    import argparse
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="Start one process per rank of a training script.")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="ranks on this host")
    p.add_argument("--nnodes", type=int, default=1, help="hosts")
    p.add_argument("--node_rank", type=int, default=0, help="this host")
    p.add_argument("--master", default=None,
                   help="host:port of rank 0 (default: 127.0.0.1 and a "
                        "free port)")
    p.add_argument("script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    # a SIGTERM ends the launcher through its finally: the ranks go too
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    master = args.master or f"127.0.0.1:{free_port()}"
    world = args.nnodes * args.nproc_per_node
    procs = []
    for local in range(args.nproc_per_node):
        rank = args.node_rank * args.nproc_per_node + local
        env = dict(os.environ)
        env.setdefault("OMP_NUM_THREADS", "1")
        env.update(rank_env(rank, world, master, local,
                            args.nproc_per_node))
        procs.append(subprocess.Popen(
            [sys.executable, args.script, *args.script_args], env=env))
    rc = 0
    try:
        while procs:
            for proc in list(procs):
                code = proc.poll()
                if code is None:
                    continue
                procs.remove(proc)
                if code != 0 and rc == 0:
                    rc = code
                    for other in procs:
                        other.terminate()
            time.sleep(0.05)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    return rc
