"""Port of the serving launcher (``repro_torch.launch.serve``) held against
the JAX package's ``repro.launch.serve``:

* ``--mode batch`` at small sizes prints the reference's numbers (engine
  model e2e, bootstrap counts, the analytic study, the real engine's
  served split and sample tokens) with the reference's weights carried
  across and its device profile passed in. The reference's batch mode
  reads ``.added`` off ``bootstrap_frontend``'s return value, which is
  None; the reference side here runs with ``bootstrap_frontend``
  returning ``SISO.bootstrap``'s stats, as the port's batch mode does.
* ``--mode replica --transport socket --device cpu`` as a user starts it:
  a router and two worker processes; a MISS, then the same tokens from the
  peer's user HIT once the delta has crossed; ``/healthz`` shows each
  worker's transport stats; SIGTERM ends all three with exit 0.
"""
import json
import os
import random
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.launch import serve as JServe
from repro.models import lm as JLM
from repro.serving import engine as JEng
from repro.serving import simulator as JSim
from repro_torch import weights
from repro_torch.configs.base import get_config
from repro_torch.launch import serve as PServe
from repro_torch.serving.engine import EngineModel

# the suite runs in several worker processes on one host: a small intra-op
# pool per process keeps them from oversubscribing the cores
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BATCH_ARGS = ["--mode", "batch", "--requests", "16", "--history", "200",
              "--dim", "16", "--capacity", "64", "--slots", "2",
              "--max-new", "4"]
_WALL = re.compile(r"\(\d+\.\d+s\)|in \d+\.\d+s")


def _numbers(text: str) -> list:
    """The printed lines with their wall-clock seconds blanked."""
    return [_WALL.sub("<s>", line) for line in text.strip().splitlines()]


@pytest.mark.parametrize("arch", ["qwen3-14b", "mixtral-8x7b", "minicpm3-4b",
                                  "deepseek-v2-236b", "rwkv6-7b",
                                  "zamba2-7b"])
def test_run_batch_prints_the_reference_numbers(monkeypatch, capsys, arch):
    """``--arch`` through ``get_config(arch).reduced()`` in both launchers:
    the dense qwen3, the MoE + sliding-window mixtral, the MLA minicpm3,
    the MLA + MoE deepseek-v2 with its dense first layer, the SSM rwkv6 and
    the hybrid zamba2 (bf16, as the launchers build them)."""
    args = BATCH_ARGS + ["--arch", arch]

    def ref_bootstrap(frontend, train):
        return frontend.bootstrap(train.vectors, train.answers,
                                  answer_ids=np.arange(len(train.vectors)))

    monkeypatch.setattr(JSim, "bootstrap_frontend", ref_bootstrap)
    assert JServe.main(args) == 0
    ref = capsys.readouterr().out

    def carried_lm(cfg, seed, device):
        jcfg = j_get_config(arch).reduced().replace(remat=False)
        jp = JLM.init_params(jax.random.PRNGKey(seed), jcfg)
        return weights.convert_lm(jax.tree.map(np.asarray, jp), cfg, device)

    monkeypatch.setattr(PServe, "_init_lm", carried_lm)
    monkeypatch.setattr(PServe, "_engine_model", lambda arch: (
        EngineModel.from_config(get_config(arch), n_chips=8,
                                peak_flops=JEng.PEAK_FLOPS,
                                hbm_bw=JEng.HBM_BW)))
    assert PServe.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert _numbers(out) == _numbers(ref), (out, ref)
    assert "cache hits" in out and len(out.strip().splitlines()) == 4


def test_user_key_and_hash_embed_match_the_reference():
    for u in (None, 7, "7", "alice", "bob@example"):
        assert PServe.user_key(u) == JServe.user_key(u)
    toks = [np.asarray([1, 2, 3]), np.asarray([9]), np.arange(40)]
    np.testing.assert_array_equal(PServe.hash_embed_fn(24)(toks),
                                  JServe.hash_embed_fn(24)(toks))
    assert PServe.REGION_NAMES == JServe.REGION_NAMES


def _free_base() -> int:
    """A base port whose router, worker and transport ports are free,
    drawn below the kernel's ephemeral range, where no OS-assigned port
    of a concurrent test lands."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = random.Random()
    for _ in range(200):
        base = rng.randrange(10_000, max(10_001, low - 1002))
        try:
            for p in (base, base + 1, base + 2, base + 1000, base + 1001):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
    pytest.fail("no free port range")


def _get(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _post(url, body, timeout=60.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _kill_group(proc) -> None:
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def _launch(log_path: Path):
    """The launcher as a user starts it, in its own process group. Returns
    (proc, url) once both workers serve, or None when a port was taken
    between the probe and a bind (the router or a worker then exits)."""
    base = _free_base()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "2"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
             "replica", "--transport", "socket", "--replicas", "2",
             "--port", str(base), "--device", "cpu", "--slots", "2"],
            env=env, stdout=log, stderr=subprocess.STDOUT,
            cwd=log_path.parent, start_new_session=True)
    url = f"http://127.0.0.1:{base}"
    deadline = time.monotonic() + 180.0
    while proc.poll() is None:
        try:
            h = _get(f"{url}/healthz")
        except (urllib.error.URLError, OSError, ValueError):
            h = None
        if h is not None and h["status"] == "serving":
            return proc, url
        if h is not None and any(r.get("status") == "exited"
                                 for r in h["replicas"].values()):
            break
        if time.monotonic() > deadline:
            _kill_group(proc)
            pytest.fail(f"workers never came up: {log_path.read_text()}")
        time.sleep(0.25)
    _kill_group(proc)
    return None


def test_socket_replica_launcher_miss_peer_hit_and_sigterm(tmp_path):
    log_path = tmp_path / "serve.log"
    for _ in range(3):
        got = _launch(log_path)
        if got is not None:
            break
    else:
        pytest.fail(f"the launcher never came up: {log_path.read_text()}")
    proc, url = got
    try:
        toks = [11, 12, 13, 14]
        st, hdr, body = _post(f"{url}/v1/query",
                              {"tokens": toks, "user": 0, "max_new": 4})
        assert st == 200 and hdr["X-Cache"] == "MISS"
        assert hdr["X-Routed-To"] == "r0" and body["tokens_out"]
        # the delta crosses: r1's transport reports r0's record applied
        deadline = time.monotonic() + 30.0
        while True:
            r1 = _get(f"{url}/healthz")["replicas"]["r1"]["replication"]
            if r1["merged_rows"] >= 1:
                break
            assert time.monotonic() < deadline, f"no delta crossed: {r1}"
            time.sleep(0.05)
        st, hdr, body = _post(f"{url}/v1/query",
                              {"tokens": toks, "user": 1, "max_new": 4})
        assert st == 200 and hdr["X-Routed-To"] == "r1"
        assert hdr["X-Cache"] == "HIT" and hdr["X-Cache-Region"] == "spill"
        health = _get(f"{url}/healthz")
        for name, other in (("r0", "r1"), ("r1", "r0")):
            t = health["replicas"][name]["replication"]["transport"]
            assert t["kind"] == "socket" and other in t["peers"]
        # r1's ack of the record crosses back to r0 after r1 applied it:
        # under load /healthz can be read before r0 has taken it
        deadline = time.monotonic() + 30.0
        while health["replicas"]["r0"]["replication"]["transport"][
                "peers"]["r1"]["acked_seq"] < 0:
            assert time.monotonic() < deadline, f"no ack reached r0: {health}"
            time.sleep(0.05)
            health = _get(f"{url}/healthz")
        assert health["replicas"]["r0"]["replication"]["transport"][
            "peers"]["r1"]["acked_seq"] >= 0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30.0) == 0, log_path.read_text()
    finally:
        if proc.poll() is None:
            _kill_group(proc)
    # the workers ended with the router: nothing is left in its group
    with pytest.raises(ProcessLookupError):
        os.killpg(proc.pid, 0)


def test_new_modules_import_no_jax_and_no_reference():
    """The replica plane, its transports, the fault hooks and the launcher
    stand alone: importing them pulls in neither ``jax`` nor ``repro``."""
    probe = (
        "import sys\n"
        "import repro_torch.distributed.replication, "
        "repro_torch.distributed.transport, "
        "repro_torch.distributed.fault_tolerance, "
        "repro_torch.launch.serve\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
