"""Runnable serving launcher: the SISO semantic cache in front of a model
(port of ``repro/launch/serve.py``, DESIGN.md §16.3).

Three modes (``--mode``):

* ``batch`` — the one-shot run: bootstrap from a synthetic history,
  run the analytic SLO study, then push a request stream through the
  reduced model with continuous batching.
* ``http`` — a thin stdlib HTTP front end over one ``ServingGateway``:
  ``POST /v1/query`` with ``{"tokens": [...]}`` answers inline on a
  cache hit or drives the engine to completion on a miss, tagging every
  response with ``X-Cache: HIT|MISS`` and ``X-Cache-Region`` headers;
  ``GET /healthz`` reports serving state. SIGTERM drains gracefully:
  in-flight work completes, new queries get 503, then the listener stops.
* ``replica`` — the same front end over N gateways in a
  :class:`ReplicaGroup` exchanging replication deltas (DESIGN.md §16),
  requests routed per user across replicas. With ``--transport socket``
  each replica runs in its **own process** with its own engine, deltas
  flow over TCP loopback (DESIGN.md §17), and the parent becomes a thin
  router: ``/v1/query`` proxies to the routed worker, ``/healthz``
  aggregates every worker's replication and transport stats.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode batch
  PYTHONPATH=src python -m repro_torch.launch.serve --mode http --port 8080
  PYTHONPATH=src python -m repro_torch.launch.serve --mode replica \\
      --transport socket --replicas 3   # one process per replica

Every mode runs on ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions). Port layout in socket mode (base = ``--port``):
the router listens on base, worker i's HTTP front end on base+1+i, worker
i's replication transport on base+1000+i.

Failures are not hidden: a request whose gateway work raises answers 500
and stops the server, which then exits 1; the socket router reports a
worker that exited in ``/healthz`` and exits 1 if any worker did not exit
cleanly.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

# region int8 -> header tag (LookupResult.region, DESIGN.md §13/§14)
REGION_NAMES = {-1: "miss", 0: "centroid", 1: "spill", 2: "warm",
                3: "cold", 4: "overlay"}

# the directory holding the ``repro_torch`` package (socket workers import
# it from there)
_PKG_ROOT = str(Path(__file__).resolve().parents[2])


def user_key(user) -> Optional[int]:
    """Stable int key for user-sticky routing and the gateway's repeat
    escape: ints pass through, anything else hashes (crc32 — stable
    across router and worker processes, unlike ``hash()``)."""
    if user is None:
        return None
    try:
        return int(user)
    except (TypeError, ValueError):
        return zlib.crc32(str(user).encode()) & 0x7FFFFFFF


def hash_embed_fn(dim: int):
    """Deterministic token-sequence embedder for the HTTP modes: crc32 of
    the token bytes seeds a unit vector, so identical queries map to
    identical cache keys without a learned embedder in the loop."""
    def fn(token_lists: Sequence[np.ndarray]) -> np.ndarray:
        out = np.zeros((len(token_lists), dim), np.float32)
        for i, toks in enumerate(token_lists):
            seed = zlib.crc32(np.asarray(toks, np.int64).tobytes())
            v = np.random.default_rng(seed).normal(size=dim)
            out[i] = (v / np.linalg.norm(v)).astype(np.float32)
        return out
    return fn


def kernel_launches() -> dict:
    """Launches of each hand-written kernel in this process (each wrapper
    counts where it launches; the plain versions on CPU tensors count
    nothing): K1/K2 cosine top-k, K4 prefill attention in bf16, in f32
    and with a value head dim other than the q/k one (MLA), K3 decode
    attention over a bf16/f32 cache, an int8 one and one with a value head
    dim other than the q/k one."""
    from repro_torch.kernels.cosine_topk import ops as ctk
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    fa_n, da_n = fa.flash_attention, da.decode_attention
    return {"cosine_topk": ctk.cosine_topk.launches,
            "cosine_topk_q8": ctk.cosine_topk_q8.launches,
            "flash_attention": (fa_n.launches - fa_n.launches_f32
                                - fa_n.launches_dv),
            "flash_attention_f32": fa_n.launches_f32,
            "flash_attention_dv": fa_n.launches_dv,
            "decode_attention": (da_n.launches - da_n.launches_int8
                                 - da_n.launches_dv),
            "decode_attention_int8": da_n.launches_int8,
            "decode_attention_dv": da_n.launches_dv}


class CacheHTTPServer(ThreadingHTTPServer):
    """stdlib HTTP front end over one or more gateways (DESIGN.md §16.3).

    ``targets`` are submit-capable objects — bare ``ServingGateway``s or
    ``Replica`` wrappers (whose ``submit`` additionally publishes
    replication deltas). One lock serializes every path that touches a
    gateway (handler threads here, a socket worker's ticker and its
    transport's state provider): the gateway pipeline is single-threaded
    by design, and the kernels' per-stream scratch assumes one caller at a
    time. Autograd is off on those paths (grad mode is per thread).
    """

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, targets: Sequence, names: Sequence[str],
                 clock=None):
        super().__init__(addr, _Handler)
        self.targets = list(targets)
        self.names = list(names)
        self.lock = threading.Lock()
        self.clock = clock or time.perf_counter
        self.draining = False
        self.failed: Optional[BaseException] = None
        self._rid = 0
        self._rr = 0

    @staticmethod
    def _gw(target):
        return target.gw if hasattr(target, "gw") else target

    def route(self, user: Optional[int]) -> int:
        """Replica index for a request: per-user sticky hash (the load-
        balancer shape), round-robin for anonymous traffic."""
        if user is not None:
            return user % len(self.targets)
        self._rr += 1
        return (self._rr - 1) % len(self.targets)

    def serve_query(self, body: dict) -> tuple[int, dict, dict]:
        """The whole request path under the lock; returns
        (http_status, response_json, extra_headers)."""
        from repro_torch.serving.gateway import GatewayRequest
        toks = np.asarray(body.get("tokens", []), np.int32)
        if toks.size == 0:
            return 400, {"error": "body needs a non-empty 'tokens' list"}, {}
        user = user_key(body.get("user"))
        with self.lock, torch.no_grad():
            if self.draining:
                return 503, {"error": "draining"}, {"Retry-After": "1"}
            ix = self.route(user)
            target = self.targets[ix]
            gw = self._gw(target)
            rid = self._rid
            self._rid += 1
            req = GatewayRequest(
                rid=rid, model_tokens=toks,
                user_id=user,
                tenant=body.get("tenant"),
                max_new=int(body.get("max_new", 16)))
            done0 = len(gw.done)    # a hit lands right after this index
            hit = bool(target.submit([req], now=self.clock())[0])
            res = gw.last_result
            out = self._await(gw, rid, done0)
            if not hit and getattr(getattr(target, "cfg", None),
                                   "sync_every", 0) > 0:
                # the miss's answer was recorded while _await drove the
                # engine — publish it now so a repeat routed to a peer
                # replica hits instead of waiting for the next submit. An
                # isolated replica (sync_every=0) never publishes; the
                # reference's front end publishes here regardless
                target.publish(self.clock())
        region = int(res.region[0])
        resp = {"rid": rid, "hit": hit, "replica": self.names[ix],
                "region": REGION_NAMES.get(region, str(region)),
                "sim": float(res.sim[0]),
                "served_by": out.served_by if out is not None else None,
                "tokens_out": (np.asarray(out.out).tolist()
                               if out is not None and out.out is not None
                               else None)}
        headers = {"X-Cache": "HIT" if hit else "MISS",
                   "X-Cache-Region": resp["region"],
                   "X-Replica": self.names[ix]}
        return 200, resp, headers

    @staticmethod
    def _await(gw, rid: int, done0: int, max_ticks: int = 10_000):
        """Drive the engine until this rid completes (hits are already in
        the done list from admit_resolved)."""
        for _ in range(max_ticks):
            for r in gw.done[done0:]:
                if r.rid == rid:
                    return r
            if not gw.sched.active and not gw.sched.queue:
                break
            gw.step()
        for r in gw.done[done0:]:
            if r.rid == rid:
                return r
        return None

    def health(self) -> dict:
        reports = {}
        for name, t in zip(self.names, self.targets):
            gw = self._gw(t)
            entry = {"submitted": gw.stats.submitted,
                     "epoch": int(getattr(gw.frontend,
                                          "refresh_epoch", 0))}
            if hasattr(t, "report"):
                # Replica wrapper: replication + transport observability
                # (pending outbox depth, retries, backoffs, last-applied
                # seqs, reconcile counts — DESIGN.md §17)
                entry["replication"] = t.report()
            reports[name] = entry
        status = "failed" if self.failed is not None else (
            "draining" if self.draining else "serving")
        return {"status": status, "replicas": reports,
                "kernel_launches": kernel_launches()}

    def begin_drain(self) -> None:
        """Graceful drain (SIGTERM): refuse new queries, complete queued
        engine work, fold pending replication records, snapshot if
        persistence is attached."""
        with self.lock, torch.no_grad():
            self.draining = True
            for t in self.targets:
                if hasattr(t, "drain"):     # Replica wrapper
                    t.drain()
                else:
                    self._gw(t).drain()

    def fail(self, exc: BaseException) -> None:
        """A gateway path raised (a CUDA fault, a kernel that refused its
        inputs): note it, print it, and stop serving. The launcher exits
        1; nothing retries on another device."""
        if self.failed is None:
            self.failed = exc
            traceback.print_exception(type(exc), exc, exc.__traceback__,
                                      file=sys.stderr)
            threading.Thread(target=self.shutdown, daemon=True).start()


class _Handler(BaseHTTPRequestHandler):
    server_version = "siso-serve/1.0"

    def log_message(self, fmt, *args):      # stay quiet under test
        pass

    def _send(self, status: int, payload: dict, headers: dict = ()) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in dict(headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, self.server.health())
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path != "/v1/query":
            self._send(404, {"error": f"no route {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._send(400, {"error": "malformed JSON body"})
            return
        if self.server.failed is not None:
            self._send(500, {"error": f"server failed: "
                                      f"{self.server.failed!r}"})
            return
        try:
            status, payload, headers = self.server.serve_query(body)
        except Exception as e:          # noqa: BLE001 - reported, then stop
            self.server.fail(e)
            self._send(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._send(status, payload, headers)


class ReplicaRouter(ThreadingHTTPServer):
    """Parent-process front door for ``--transport socket``: proxies
    ``/v1/query`` to the routed worker (per-user sticky, round-robin for
    anonymous traffic) and aggregates every worker's ``/healthz`` —
    replication lag shows up here, not in worker logs. A worker process
    that has exited is reported with its exit code."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, worker_host: str, worker_ports: Sequence[int],
                 names: Sequence[str], procs: Sequence = ()):
        super().__init__(addr, _RouterHandler)
        self.worker_host = worker_host
        self.worker_ports = list(worker_ports)
        self.names = list(names)
        self.procs = list(procs)
        self.draining = False
        self._rr = 0
        self._rr_lock = threading.Lock()

    def route(self, user: Optional[int]) -> int:
        if user is not None:
            return user % len(self.worker_ports)
        with self._rr_lock:
            self._rr += 1
            return (self._rr - 1) % len(self.worker_ports)

    def forward_query(self, raw_body: bytes, user: Optional[int]
                      ) -> tuple[int, dict, dict]:
        if self.draining:
            return 503, {"error": "draining"}, {"Retry-After": "1"}
        ix = self.route(user)
        url = (f"http://{self.worker_host}:{self.worker_ports[ix]}"
               f"/v1/query")
        req = urllib.request.Request(
            url, data=raw_body, method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120.0) as resp:
                payload = json.loads(resp.read())
                headers = {k: v for k, v in resp.headers.items()
                           if k.startswith("X-")}
                headers["X-Routed-To"] = self.names[ix]
                return resp.status, payload, headers
        except urllib.error.HTTPError as e:      # worker said 4xx/5xx
            try:
                payload = json.loads(e.read())
            except (ValueError, json.JSONDecodeError):
                payload = {"error": f"worker {self.names[ix]}: {e.code}"}
            return e.code, payload, {"X-Routed-To": self.names[ix]}
        except (urllib.error.URLError, OSError, TimeoutError):
            return 503, {"error": f"worker {self.names[ix]} unavailable"}, \
                {"Retry-After": "1"}

    def _exit_code(self, i: int) -> Optional[int]:
        return self.procs[i].poll() if i < len(self.procs) else None

    def health(self) -> dict:
        replicas = {}
        statuses = []
        for i, (name, port) in enumerate(zip(self.names, self.worker_ports)):
            code = self._exit_code(i)
            if code is not None:
                statuses.append("exited")
                replicas[name] = {"status": "exited", "exit_code": code}
                continue
            url = f"http://{self.worker_host}:{port}/healthz"
            try:
                with urllib.request.urlopen(url, timeout=5.0) as resp:
                    h = json.loads(resp.read())
                statuses.append(h.get("status", "unknown"))
                replicas[name] = h.get("replicas", {}).get(name, h)
                replicas[name]["status"] = statuses[-1]
            except (urllib.error.URLError, OSError, ValueError,
                    TimeoutError):
                statuses.append("unreachable")
                replicas[name] = {"status": "unreachable"}
        status = "draining" if self.draining else (
            "serving" if all(s == "serving" for s in statuses)
            else "degraded")
        return {"status": status, "transport": "socket",
                "replicas": replicas}


class _RouterHandler(BaseHTTPRequestHandler):
    server_version = "siso-router/1.0"

    def log_message(self, fmt, *args):
        pass

    _send = _Handler._send

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, self.server.health())
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path != "/v1/query":
            self._send(404, {"error": f"no route {self.path}"})
            return
        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n) or b"{}"
        try:
            user = user_key(json.loads(raw).get("user"))
        except (ValueError, json.JSONDecodeError):
            self._send(400, {"error": "malformed JSON body"})
            return
        status, payload, headers = self.server.forward_query(raw, user)
        self._send(status, payload, headers)


# ---------------------------------------------------------------------------
# the modes
# ---------------------------------------------------------------------------


def _serving_config(args):
    from repro_torch.serving.config import (CacheConfig, RefreshConfig,
                                            ServingConfig)
    return ServingConfig(
        cache=CacheConfig(dim=args.dim, answer_dim=args.dim,
                          capacity=args.capacity,
                          dynamic_threshold=not args.no_dta),
        refresh=RefreshConfig(min=args.refresh_min),
        slo_latency=args.slo, llm_latency=args.slo / 1.3)


def _init_lm(cfg, seed: int, device):
    """The reduced model's weights from ``seed``: an explicit generator on
    ``device``, so every process given the same seed builds the same
    weights."""
    from repro_torch.models import lm
    gen = torch.Generator(device=device).manual_seed(seed)
    return lm.init_params(gen, cfg, device=device)


def _engine_model(arch: str):
    """The analytic engine of ``--mode batch``: the model on one H100."""
    from repro_torch.configs.base import get_config
    from repro_torch.serving.engine import EngineModel
    return EngineModel.from_config(get_config(arch), n_chips=1)


def _make_engine(args):
    from repro_torch.configs.base import get_config
    from repro_torch.device import resolve_device
    from repro_torch.serving.engine import ModelEngine
    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = _init_lm(cfg, args.seed, dev)
    return ModelEngine(params, cfg, n_slots=args.slots, max_len=128,
                       device=dev), cfg


def _answer_fn(embed):
    # without an answer_fn the scheduler records nothing on completion
    # and repeat queries can never hit: embed the generated tokens with
    # the same hasher so the answer key is deterministic too
    return lambda toks: embed([np.asarray(toks)])[0]


def run_http(args) -> int:
    """--mode http / --mode replica: N gateways behind the front end."""
    from repro_torch.distributed.replication import (ReplicaGroup,
                                                     ReplicationConfig)
    from repro_torch.serving.gateway import ServingGateway
    if args.mode == "replica" and args.transport == "socket":
        if args.worker_index >= 0:
            return _run_socket_worker(args)
        return _run_socket_parent(args)
    n = args.replicas if args.mode == "replica" else 1
    cfg = _serving_config(args)
    embed = hash_embed_fn(args.dim)
    engine, _ = _make_engine(args)
    gws = [ServingGateway.from_config(cfg, engine=engine, embed_fn=embed,
                                      answer_fn=_answer_fn(embed))
           for _ in range(n)]
    names = [f"r{i}" for i in range(n)]
    if n > 1:
        group = ReplicaGroup(cfg.replication or ReplicationConfig())
        targets = [group.add(name, gw) for name, gw in zip(names, gws)]
    else:
        targets = gws
    server = CacheHTTPServer((args.host, args.port), targets, names)
    host, port = server.server_address[:2]
    print(f"serving {n} replica(s) on http://{host}:{port} "
          f"(POST /v1/query, GET /healthz) on {engine.device}", flush=True)

    def _sigterm(signum, frame):
        print("SIGTERM: draining...", flush=True)
        threading.Thread(target=_drain_and_stop, args=(server,),
                         daemon=True).start()

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        server.serve_forever(poll_interval=0.2)
    except KeyboardInterrupt:
        server.begin_drain()
    finally:
        server.server_close()
    return 1 if server.failed is not None else 0


def _drain_and_stop(server, transport=None) -> None:
    """The SIGTERM body, off the main thread (the main thread is inside
    serve_forever and must keep polling for shutdown)."""
    try:
        server.begin_drain()       # finishes in-flight, folds, publishes
        if transport is not None:
            transport.flush(5.0)
    except Exception as e:         # noqa: BLE001 - reported, exit 1
        server.fail(e)
    server.shutdown()


def _run_socket_worker(args) -> int:
    """One replica process: its own engine + gateway + SocketTransport,
    full mesh to the other workers. Internal entry point — the parent
    spawns this via ``--worker-index``."""
    from repro_torch.distributed.replication import (Replica,
                                                     ReplicationConfig)
    from repro_torch.distributed.transport import (SocketTransport,
                                                   TransportConfig)
    from repro_torch.serving.gateway import ServingGateway
    i, n = args.worker_index, args.replicas
    name = f"r{i}"
    cfg = _serving_config(args)
    embed = hash_embed_fn(args.dim)
    engine, _ = _make_engine(args)
    gw = ServingGateway.from_config(cfg, engine=engine, embed_fn=embed,
                                    answer_fn=_answer_fn(embed))
    tcfg = TransportConfig(kind="socket", host=args.host,
                           port=args.port + 1000 + i)
    transport = SocketTransport(name, tcfg)
    rep = Replica(name, gw, transport, ReplicationConfig(n_replicas=n))
    for j in range(n):
        if j != i:
            transport.connect(f"r{j}", (args.host, args.port + 1000 + j))
    server = CacheHTTPServer((args.host, args.port + 1 + i), [rep], [name])

    def _state_provider():
        # reconcile donor runs on a transport reader thread; serialize
        # against the serving path, bounded so a wedged lock surfaces as
        # a requester timeout instead of a deadlock
        if not server.lock.acquire(timeout=2.0):
            return None
        try:
            return rep._reconcile_payload(copy=False)
        finally:
            server.lock.release()

    transport.state_provider = _state_provider
    stop = threading.Event()

    def _ticker():
        # fold peer deltas even when no requests arrive (an idle worker
        # must still apply, ack, and reconcile)
        while not stop.wait(0.05):
            try:
                with server.lock, torch.no_grad():
                    if not server.draining:
                        rep.apply_pending(rep.cfg.apply_budget)
            except Exception as e:      # noqa: BLE001 - reported, exit 1
                server.fail(e)
                return

    ticker = threading.Thread(target=_ticker, daemon=True)
    ticker.start()
    print(f"worker {name}: http={args.port + 1 + i} "
          f"transport={args.port + 1000 + i} device={engine.device}",
          flush=True)

    def _sigterm(signum, frame):
        threading.Thread(target=_drain_and_stop, args=(server, transport),
                         daemon=True).start()

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        server.serve_forever(poll_interval=0.2)
    except KeyboardInterrupt:
        server.begin_drain()
    finally:
        stop.set()
        ticker.join(timeout=2.0)
        rep.close()
        server.server_close()
    return 1 if server.failed is not None else 0


def _run_socket_parent(args) -> int:
    """Parent: spawn one worker process per replica, then route."""
    names = [f"r{i}" for i in range(args.replicas)]
    ports = [args.port + 1 + i for i in range(args.replicas)]
    base = [sys.executable, "-m", "repro_torch.launch.serve",
            "--mode", "replica", "--transport", "socket",
            "--replicas", str(args.replicas),
            "--host", args.host, "--port", str(args.port),
            "--arch", args.arch, "--dim", str(args.dim),
            "--capacity", str(args.capacity), "--slots", str(args.slots),
            "--refresh-min", str(args.refresh_min),
            "--slo", str(args.slo), "--seed", str(args.seed),
            "--device", args.device]
    if args.no_dta:
        base.append("--no-dta")
    env = dict(os.environ)
    env["PYTHONPATH"] = _PKG_ROOT + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    procs = [subprocess.Popen(base + ["--worker-index", str(i)], env=env)
             for i in range(args.replicas)]
    try:
        router = ReplicaRouter((args.host, args.port), args.host, ports,
                               names, procs)
    except OSError:
        for p in procs:
            p.kill()
            p.wait()
        raise
    host, port = router.server_address[:2]
    print(f"routing {args.replicas} worker replica(s) on "
          f"http://{host}:{port} (POST /v1/query, GET /healthz)",
          flush=True)

    def _sigterm(signum, frame):
        print("SIGTERM: draining workers...", flush=True)
        router.draining = True
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        threading.Thread(target=router.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        router.serve_forever(poll_interval=0.2)
    except KeyboardInterrupt:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
    finally:
        router.server_close()
        for p in procs:
            try:
                p.wait(timeout=30.0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        print(f"worker exit codes {dict(zip(names, codes))}",
              file=sys.stderr, flush=True)
        return 1
    return 0


def run_batch(args) -> int:
    """The one-shot run (analytic study + real engine pass), constructed
    from a ServingConfig."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.synth import SyntheticWorkload
    from repro_torch.device import resolve_device
    from repro_torch.serving.engine import AnalyticEngine, ModelEngine
    from repro_torch.serving.scheduler import (ContinuousBatchScheduler,
                                               Request)
    from repro_torch.serving.simulator import ServingSimulator, build_system
    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    wl = SyntheticWorkload(args.profile, dim=args.dim, n_clusters=500,
                           seed=args.seed)
    model = _engine_model(args.arch)
    L = model.e2e(wl.profile.avg_tokens_in, wl.profile.avg_tokens_out)
    print(f"engine model: zero-load e2e = {L:.3f}s")

    # --- offline path: bootstrap the cache from history ---
    siso = build_system("siso-nodta" if args.no_dta else "siso",
                        dim=args.dim, capacity=args.capacity,
                        slo_latency=1.3 * L, llm_latency=L, device=dev)
    hist = wl.sample(args.history, rps=100.0)
    t0 = time.time()
    # SISO.bootstrap directly: it returns the RefreshStats printed below
    # (bootstrap_frontend returns None)
    stats = siso.bootstrap(hist.vectors, hist.answers,
                           answer_ids=np.arange(len(hist.vectors)))
    print(f"bootstrap: {stats.added} centroids added, "
          f"{stats.evicted} filtered, cache={len(siso.cache.centroids)} "
          f"({time.time() - t0:.1f}s)")

    # --- online path A: analytic engine (SLO study at the target scale) ---
    sim = ServingSimulator(AnalyticEngine(model, concurrency=args.slots),
                           siso)
    test = wl.sample(args.requests, rps=args.rps, cv=args.cv)
    r = sim.run(test, name="siso")
    print(f"[analytic] hit={r.hit_ratio:.3f} slo={r.slo_attainment:.3f} "
          f"e2e={r.mean_e2e:.3f}s quality={r.mean_quality:.3f} "
          f"theta_R(final)={r.theta_trace[-1] if r.theta_trace else None}")

    # --- online path B: real reduced model through continuous batching ---
    params = _init_lm(cfg, args.seed, dev)
    engine = ModelEngine(params, cfg, n_slots=args.slots, max_len=128,
                         device=dev)
    sched = ContinuousBatchScheduler(engine, cache=siso)
    rng = np.random.default_rng(args.seed)
    n_real = min(args.requests, 32)
    reqs = wl.sample(n_real, rps=args.rps)
    t0 = time.time()
    for i in range(n_real):
        toks = rng.integers(0, cfg.vocab_size, size=rng.integers(4, 12))
        sched.submit(Request(rid=i, tokens=toks.astype(np.int32),
                             max_new=args.max_new,
                             vector=reqs.vectors[i]))
        sched.step()
    done = sched.drain()
    by = {"cache": 0, "engine": 0}
    for rq in done:
        by[rq.served_by] += 1
    print(f"[real engine] {len(done)} served in {time.time() - t0:.1f}s — "
          f"cache hits {by['cache']}, engine {by['engine']}; "
          f"sample output tokens: {done[-1].out[:8]}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("batch", "http", "replica"),
                    default="batch")
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--profile", default="quora")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--history", type=int, default=3000)
    ap.add_argument("--rps", type=float, default=20.0)
    ap.add_argument("--cv", type=float, default=1.0)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--capacity", type=int, default=256)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--no-dta", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device every mode runs on (cpu runs the "
                         "kernels' plain versions)")
    # http/replica mode
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--transport", choices=("inproc", "socket"),
                    default="inproc")
    ap.add_argument("--worker-index", type=int, default=-1,
                    help=argparse.SUPPRESS)   # internal: socket worker
    ap.add_argument("--refresh-min", type=int, default=32)
    ap.add_argument("--slo", type=float, default=1.0)
    args = ap.parse_args(argv)
    if args.mode == "batch":
        return run_batch(args)
    return run_http(args)


if __name__ == "__main__":
    raise SystemExit(main())
