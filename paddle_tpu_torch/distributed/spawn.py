"""``paddle.distributed.spawn``: the port of
``paddle_tpu/distributed/spawn.py``.

Starts ``nprocs`` processes (the ``spawn`` start method, never ``fork``:
a forked child of a process holding a CUDA context cannot use the card),
each running ``func(*args)`` with the launcher's environment contract
(``launch.rank_env``: ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``, and torch's
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``) and one
intra-op thread: ``func`` then calls ``init_parallel_env``.  As the JAX
spawn, it terminates the survivors as soon as a rank fails (a crashed
rank must not leave its peers blocked in a collective) and re-raises the
failure.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback
from typing import Optional

from ..framework.errors import enforce

__all__ = ["spawn"]


def _worker(fn, env, args, error_queue, threads: int):
    os.environ.update(env)
    import torch
    torch.set_num_threads(threads)
    try:
        fn(*args)
    except Exception:
        error_queue.put((env["PADDLE_TRAINER_ID"], traceback.format_exc()))
        raise


def spawn(func, args=(), nprocs: int = -1, join: bool = True,
          daemon: bool = False, timeout: Optional[float] = None,
          threads: int = 1, **options):
    """Launch ``nprocs`` processes running ``func(*args)``.  Returns the
    processes when ``join=False``; otherwise waits for them and raises the
    first failure (``RuntimeError`` with its traceback)."""
    from .launch import free_port, rank_env
    enforce(not options, f"spawn got unsupported options {sorted(options)}")
    if nprocs == -1:
        nprocs = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    enforce(nprocs >= 1, "spawn needs nprocs >= 1")
    ctx = mp.get_context("spawn")
    error_queue = ctx.Queue()
    master = f"127.0.0.1:{free_port()}"
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_worker,
                        args=(func, rank_env(rank, nprocs, master),
                              tuple(args), error_queue, threads),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if not join:
        return procs
    deadline = None if timeout is None else time.monotonic() + timeout
    failure = None
    try:
        while any(p.is_alive() for p in procs):
            try:
                failure = error_queue.get(timeout=0.2)
                break
            except queue.Empty:
                pass
            for p in procs:
                if not p.is_alive() and p.exitcode not in (0, None):
                    try:
                        failure = error_queue.get(timeout=2.0)
                    except queue.Empty:
                        failure = (f"pid {p.pid}", f"exit code {p.exitcode}")
                    break
            if failure is not None:
                break
            if deadline is not None and time.monotonic() > deadline:
                failure = ("-", f"spawn timed out after {timeout}s")
                break
    finally:
        if failure is not None:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join()
    if failure is None and not error_queue.empty():
        failure = error_queue.get()
    if failure is not None:
        raise RuntimeError(f"spawned rank {failure[0]} failed:\n{failure[1]}")
    for p in procs:
        enforce(p.exitcode == 0,
                f"spawned process exited with code {p.exitcode}")
    return procs
