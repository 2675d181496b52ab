"""The training half of ``distributed.fault_tolerance`` held against the
reference on the CPU: ``ElasticRunner`` through a node loss (the
reference's test at ``tests/test_distributed.py:153``, its run in one
subprocess with 8 forced host devices, the port's on ``[cpu] * 8``: the
same log, failure events, final state and mesh), the watchdog
(``:179``), restart from a checkpoint (``:189``); ``remesh``,
``to_host`` and ``reshard``; elastic training with the sharded train step
against an uninterrupted run; and ``examples/torch_elastic_training.py``.
"""
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import get_config
from repro_torch.distributed import sharded_train as st
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fault_tolerance import (ElasticRunner,
                                                     FaultInjector,
                                                     StepWatchdog,
                                                     largest_mesh_shape,
                                                     remesh, reshard,
                                                     to_host)
from repro_torch.launch.train import synth_batch
from repro_torch.models import lm
from repro_torch.training import optimizer as opt

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
CPU = torch.device("cpu")

_REFERENCE = r"""
import pickle, sys
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro.distributed.fault_tolerance import (ElasticRunner, FaultInjector,
                                               reshard, to_host)

def make_step(mesh):
    def step(state):
        return jax.tree.map(lambda x: x + 1.0, state)
    jit_step = jax.jit(step)
    shard = lambda host: reshard(host, {"w": P("data")}, mesh)
    return (lambda s: jit_step(s)), shard, to_host

inj = FaultInjector(node_loss_steps={3: 4})
r = ElasticRunner(make_step, model_parallel=1, injector=inj)
state = r.run({"w": np.arange(8, dtype=np.float32)}, n_steps=6)
with open(sys.argv[1], "wb") as f:
    pickle.dump({"state": state, "log": r.log, "size": r.mesh.devices.size,
                 "shape": dict(r.mesh.shape),
                 "events": [(e.step, e.kind, e.detail) for e in inj.events],
                 "flagged": r.watchdog.flagged}, f)
"""


def test_elastic_runner_survives_node_loss_as_the_reference(tmp_path):
    """Lose 4 of 8 devices at step 3: one remesh, the state stepped 6
    times, a (4, 1) mesh; the same log, events and state as the
    reference's run."""
    path = tmp_path / "ref.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(path, "rb") as f:
        ref = pickle.load(f)

    def make_step(mesh):
        def step(state):
            return shd.tree_map(lambda x: x.map_blocks(lambda b: b + 1.0),
                                state)
        shard = lambda host: reshard(host, {"w": shd.P("data")}, mesh)
        return step, shard, to_host

    inj = FaultInjector(node_loss_steps={3: 4})
    r = ElasticRunner(make_step, devices=[CPU] * 8, model_parallel=1,
                      injector=inj)
    state = r.run({"w": np.arange(8, dtype=np.float32)}, n_steps=6)
    np.testing.assert_array_equal(state["w"].numpy(), ref["state"]["w"])
    assert r.log == ref["log"] == ["step 3: remesh 8->4"]
    assert r.mesh.devices.size == ref["size"] == 4
    assert dict(r.mesh.shape) == ref["shape"]
    assert [(e.step, e.kind, e.detail) for e in inj.events] == ref["events"]


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(factor=3.0)
    for i in range(8):
        wd.observe(i, 0.1)
    assert not wd.flagged
    assert wd.observe(9, 1.0)
    assert wd.flagged and wd.flagged[0][0] == 9


def test_checkpoint_restart_resumes_state():
    def make_step(mesh):
        def step(state):
            return {"w": state["w"] + 1.0}
        return step, (lambda h: h), (lambda d: d)

    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, keep=2)
        r = ElasticRunner(make_step, devices=[CPU], model_parallel=1,
                          ckpt_manager=cm, ckpt_every=2)
        r.run({"w": np.zeros(2)}, n_steps=5)
        step, state = r.resume()       # simulated restart
        assert step == 4
        np.testing.assert_allclose(state["w"], 4.0)


def test_remesh_keeps_model_groups_whole():
    assert largest_mesh_shape(8, 2) == (4, 2)
    assert largest_mesh_shape(7, 2) == (3, 2)
    with pytest.raises(RuntimeError):
        largest_mesh_shape(1, 2)
    devs = [torch.device("cpu"), torch.device("meta")] * 3 + [CPU]
    mesh = remesh(devs, 2)
    assert dict(mesh.shape) == {"data": 3, "model": 2}
    assert list(mesh.devices.flat) == devs[:6]


def test_to_host_keeps_bf16_bits_and_reshard_places_them():
    """``to_host`` gives CPU tensors (a placed one gathered), bf16 bit for
    bit; through a checkpoint and ``reshard`` onto another mesh the same
    bits come back."""
    x = torch.randn(6, 5).to(torch.bfloat16)
    mesh = remesh([CPU] * 4, 2)
    placed = reshard({"x": x, "y": np.arange(3.0)},
                     {"x": shd.P("data", "model"), "y": shd.P()}, mesh)
    host = to_host(placed)
    assert host["x"].dtype == torch.bfloat16 and host["x"].device == CPU
    assert torch.equal(host["x"].view(torch.int16), x.view(torch.int16))
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d)
        cm.save(1, {"state": host})
        _, back = cm.restore_latest()
    again = reshard(back["state"], {"x": shd.P("model"), "y": shd.P()},
                    remesh([CPU] * 2, 2))
    assert torch.equal(shd.gather(again["x"]).view(torch.int16),
                       x.view(torch.int16))
    np.testing.assert_array_equal(shd.gather(again["y"]).numpy(),
                                  np.arange(3.0))


def _elastic_training(devices, injector, ckpt_dir=None, n_steps=6):
    """Reduced f32 qwen3 (2 layers) trained by the sharded step under an
    ``ElasticRunner``; step s draws its batch from ``default_rng(s)``."""
    cfg = get_config("qwen3-14b").reduced().replace(dtype="float32",
                                                    n_layers=2)
    optc = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, CPU)

    def make_step(mesh):
        sf = st.make_sharded_train_step(cfg, mesh, optc=optc, ce_chunk=16)
        specs = shd.param_specs(params, cfg, fsdp=True)

        def step(state):
            s = state["opt"].step
            batch = st.place_batch(synth_batch(
                cfg, np.random.default_rng(s), 4, 16, CPU), cfg, mesh)
            params, ostate, _ = sf(state["params"], state["opt"], batch)
            return {"params": params, "opt": ostate}

        def shard(host):
            return {"params": reshard(host["params"], specs, mesh),
                    "opt": opt.AdamWState(
                        int(host["opt"]["step"]),
                        reshard(host["opt"]["m"], specs, mesh),
                        reshard(host["opt"]["v"], specs, mesh))}

        def unshard(state):
            return {"params": to_host(state["params"]),
                    "opt": {"step": np.asarray(state["opt"].step),
                            "m": to_host(state["opt"].m),
                            "v": to_host(state["opt"].v)}}
        return step, shard, unshard

    state0 = {"params": params,
              "opt": {"step": np.zeros((), np.int32),
                      "m": opt.init_state(params).m,
                      "v": opt.init_state(params).v}}
    cm = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
    r = ElasticRunner(make_step, devices=devices, model_parallel=1,
                      injector=injector, ckpt_manager=cm, ckpt_every=2)
    return r, r.run(state0, n_steps=n_steps)


def test_elastic_sharded_training_equals_the_uninterrupted_run(tmp_path):
    """4 virtual devices, 2 lost at step 3, a checkpoint every 2 steps:
    one remesh, a (2, 1) mesh after it, and the end state within 1e-5 of
    an uninterrupted run on 4 devices; ``resume()`` returns the step-6
    checkpoint, equal to the end state."""
    r, state = _elastic_training([CPU] * 4, FaultInjector({3: 2}),
                                 str(tmp_path))
    assert r.log == ["step 3: remesh 4->2"]
    assert dict(r.mesh.shape) == {"data": 2, "model": 1}
    _, whole = _elastic_training([CPU] * 4, FaultInjector())
    assert int(state["opt"]["step"]) == int(whole["opt"]["step"]) == 6
    for key in ("params", "m", "v"):
        a = state["params"] if key == "params" else state["opt"][key]
        b = whole["params"] if key == "params" else whole["opt"][key]
        for (path, x), (_, y) in zip(opt.tree_leaves(a), opt.tree_leaves(b)):
            top = max(float(y.abs().max()), 1e-30)
            assert float((x - y).abs().max()) <= 1e-5 * max(top, 1.0), \
                (key, path)
    step, back = r.resume()
    assert step == 6
    for (path, x), (_, y) in zip(opt.tree_leaves(back["params"]),
                                 opt.tree_leaves(state["params"])):
        assert torch.equal(torch.as_tensor(x), y), path


def test_example_runs_on_virtual_cpu_devices():
    run = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_elastic_training.py"),
         "--device", "cpu"],
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "2"},
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    out = run.stdout
    assert "starting on 8 devices" in out
    assert "failure log: ['step 4: remesh 8->4']" in out
    assert "resumed from checkpoint at step 6" in out
    assert out.strip().endswith("elastic training complete.")
