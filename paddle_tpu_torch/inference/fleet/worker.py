"""Fleet engine worker: one ServingEngine behind localhost HTTP, the
port's own copy of ``paddle_tpu/inference/fleet/worker.py``.

Spawned by :class:`..replica.ReplicaManager` as

    python -m paddle_tpu_torch.inference.fleet.worker \
        --replica-id I [--port P] [--run-dir D] [--device cuda|cpu] \
        --model '<json spec>'

The model spec is ``{"seed": s, "config": {GPTConfig kwargs}, "engine":
{ServingEngine kwargs}, "device": d}``.  Every worker draws its weights
from the seed (``convert.random_state``), so fleet replicas hold
identical weights — the invariant that makes greedy decode token-exact
across replicas and router failover provable against a single-engine
reference.  ``device`` (or ``--device``, which takes precedence) is where
the engine runs; none means ``cuda``, and without a card the worker
raises before its handshake.  It never falls back to the CPU by itself.

Once the server is bound the worker prints ONE handshake line

    ptpu-fleet-worker ready replica=<i> port=<p> pid=<pid>

and flushes — with ephemeral ports (``PTPU_FLEET_PORT_BASE=0``) this
is how the manager learns where to dial.  A background thread steps
the engine whenever work is queued; HTTP handlers and the step loop
share one lock, so requests observe step-boundary state (and every
device call of the engine runs under that lock, one at a time).

Endpoints (all JSON): ``POST /submit`` (spill-format record →
``admit_record``), ``GET /poll?rid=&start=``, ``POST /cancel``,
``POST /drain`` (returns ``spilled_records`` inline for migration),
``POST /shutdown``, ``GET /healthz``, ``GET /statusz``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

__all__ = ["build_model", "build_engine", "serve_worker", "main"]


def build_model(spec):
    """The spec's decoder with its seeded weights, on the spec's device
    (``"device"``; none means ``cuda``)."""
    from ...convert import load_jax_state, random_state
    from ...models.gpt import GPTConfig, GPTForCausalLM

    model = GPTForCausalLM(GPTConfig(**spec.get("config", {})),
                           device=spec.get("device"))
    load_jax_state(model, random_state(model, int(spec.get("seed", 7))))
    model.eval()
    return model


def build_engine(spec, replica_id: int, run_dir=None):
    """Deterministically build the decoder + engine from a JSON spec."""
    from ..engine import ServingEngine

    kw = dict(spec.get("engine", {}))
    return ServingEngine(build_model(spec), replica_id=replica_id,
                         run_dir=run_dir, **kw)


class _WorkerState:
    def __init__(self, engine):
        self.engine = engine
        self.lock = threading.Lock()
        self.shutdown = threading.Event()

    def step_loop(self):
        while not self.shutdown.is_set():
            stepped = False
            with self.lock:
                if (self.engine.state == "serving"
                        and self.engine.has_work()):
                    self.engine.step()
                    stepped = True
            # the lock is not fair: released and taken again at once, it
            # would starve the handlers waiting on it for as long as the
            # engine has work.  The yield between steps lets them in.
            time.sleep(0.0 if stepped else 0.002)


def _make_handler(state: _WorkerState):
    engine = state.engine

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):   # no per-request stderr spam
            pass

        def _reply(self, code: int, payload) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self):
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b"{}"
            return json.loads(raw.decode() or "{}")

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                with state.lock:
                    st = engine.state
                    shed = engine.should_shed()
                if st != "serving":
                    return self._reply(503, {"state": st})
                if shed:
                    return self._reply(503, {"state": "load-shed"})
                return self._reply(200, {"state": "serving"})
            if url.path == "/statusz":
                with state.lock:
                    return self._reply(200, {"serving": engine.stats()})
            if url.path == "/poll":
                q = parse_qs(url.query)
                rid = q.get("rid", [""])[0]
                start = int(q.get("start", ["0"])[0])
                with state.lock:
                    seq = engine.sched.finished.get(rid)
                    if seq is None:
                        live = (list(engine.sched.running)
                                + list(engine.sched.waiting))
                        seq = next((s for s in live
                                    if s.request_id == rid), None)
                    if seq is None:
                        return self._reply(
                            404, {"error": f"unknown request {rid!r}"})
                    return self._reply(
                        200, {"tokens": list(seq.output[start:]),
                              "finished": seq.finish_reason is not None,
                              "reason": seq.finish_reason})
            return self._reply(404, {"error": f"no route {url.path}"})

        def do_POST(self):
            url = urlparse(self.path)
            try:
                body = self._body()
            except Exception as e:
                return self._reply(400, {"error": f"bad JSON: {e}"})
            if url.path == "/submit":
                try:
                    with state.lock:
                        rid = engine.admit_record(body["record"])
                    return self._reply(200, {"request_id": rid})
                except Exception as e:
                    return self._reply(503, {"error": str(e)})
            if url.path == "/cancel":
                with state.lock:
                    ok = engine.cancel(body.get("request_id", ""))
                return self._reply(200, {"cancelled": ok})
            if url.path == "/drain":
                try:
                    with state.lock:
                        report = engine.drain(timeout=body.get("timeout"))
                    return self._reply(
                        200, {"finished": report["finished"],
                              "spilled_records": report["spilled_records"],
                              "timed_out": report["timed_out"]})
                except Exception as e:
                    return self._reply(500, {"error": str(e)})
            if url.path == "/shutdown":
                with state.lock:
                    if engine.state == "serving":
                        engine.stop()
                state.shutdown.set()
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()
                return self._reply(200, {"stopped": True})
            return self._reply(404, {"error": f"no route {url.path}"})

    return Handler


def serve_worker(engine, replica_id: int, port: int = 0,
                 host: str = "127.0.0.1",
                 handshake_stream=None) -> None:
    """Run the worker loop until ``/shutdown`` (blocking)."""
    state = _WorkerState(engine)
    httpd = ThreadingHTTPServer((host, port), _make_handler(state))
    bound = httpd.server_address[1]
    stream = handshake_stream or sys.stdout
    print(f"ptpu-fleet-worker ready replica={replica_id} "  # noqa: print — the spawn handshake IS the console contract
          f"port={bound} pid={os.getpid()}", file=stream, flush=True)
    stepper = threading.Thread(target=state.step_loop,
                               name=f"fleet-step-{replica_id}",
                               daemon=True)
    stepper.start()
    try:
        httpd.serve_forever(poll_interval=0.05)
    finally:
        state.shutdown.set()
        stepper.join(timeout=5)
        httpd.server_close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--replica-id", type=int, required=True)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--model", required=True,
                    help="JSON model spec (seed/config/engine kwargs)")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu; overrides the spec's device "
                         "(default: the spec's, else cuda)")
    args = ap.parse_args(argv)
    spec = json.loads(args.model)
    if args.device is not None:
        spec["device"] = args.device
    run_dir = args.run_dir
    if run_dir is None:
        # drain() must always have somewhere durable to spill — a
        # worker without an operator-chosen run_dir gets a private one
        import tempfile
        run_dir = tempfile.mkdtemp(prefix="ptpu-fleet-worker-")
    mdir = os.environ.get("PTPU_METRICS_DIR")
    if mdir:
        # request tracing: write this worker's stream under
        # its own id (router owns worker-0) so the per-replica JSONL
        # files merge without colliding, and flush every record so the
        # SIGKILL victim's spans survive for the trace assembler
        from ...observability.registry import get_registry
        from ...observability.sinks import MetricsWriter
        reg = get_registry()
        for sink in list(reg.sinks):
            if isinstance(sink, MetricsWriter):
                reg.remove_sink(sink)
        reg.add_sink(MetricsWriter(mdir, worker_id=args.replica_id + 1,
                                   flush_every=1))
    engine = build_engine(spec, args.replica_id, run_dir=run_dir)
    serve_worker(engine, args.replica_id, port=args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
