"""The port's trainers on the CPU: ``python -m repro_torch.launch.train
--reduced --device cpu`` lowers its loss in 10 steps and prints the
reference's lines; a run stopped at a checkpoint and resumed with
``--resume`` equals the uninterrupted run bit for bit (params, moments,
losses); on a mesh with more than one data rank an MoE model whose
dispatch takes its capacity from the whole batch raises;
``launch.train_embedder`` widens the dup/non-dup similarity gap of the
reduced embedder, and its ``wrap_step`` hook sees every step; the
prefill and decode step builders are ``lm``'s calls without grad.
"""
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.launch import steps, train, train_embedder
from repro_torch.models import lm
from repro_torch.training.optimizer import tree_leaves

torch.set_num_threads(2)

SRC = Path(__file__).resolve().parents[1] / "src"


def test_train_module_loss_decreases_on_the_cpu():
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--steps", "10", "--device", "cpu"],
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "2"},
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = run.stdout.splitlines()
    assert sum(line.startswith("step ") for line in lines) == 10
    assert "(DECREASED)" in lines[-1], run.stdout


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """A 6-step run checkpoints after steps 3 and 6; with the step-6
    checkpoint removed (the run as if killed after step 5), ``--resume``
    restarts from step 3 and must end where the whole run ended."""
    d = tmp_path / "ckpt"
    argv = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "32",
            "--steps", "6", "--ckpt-dir", str(d), "--ckpt-every", "3"]
    whole = train.run(argv)
    shutil.rmtree(d / "step_00000006")
    rest = train.run(argv + ["--resume"])
    assert rest["losses"] == whole["losses"][3:]
    assert rest["state"].step == whole["state"].step == 6
    for a, b in ((rest["params"], whole["params"]),
                 (rest["state"].m, whole["state"].m),
                 (rest["state"].v, whole["state"].v)):
        for (path, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
            assert x.dtype == y.dtype and torch.equal(x, y), path


def test_an_explicit_learning_rate_of_zero_is_kept():
    """``--lr 0`` is taken as given, not replaced by the default: the
    step leaves every parameter as it was initialised."""
    got = train.run(["--reduced", "--device", "cpu", "--batch", "1",
                     "--seq", "16", "--steps", "1", "--lr", "0"])
    cfg = get_config("qwen3-14b").replace(remat=False).reduced()
    init = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    for (path, x), (_, y) in zip(tree_leaves(got["params"]),
                                 tree_leaves(init)):
        assert torch.equal(x, y), path


def test_mesh_flags_raise():
    """``--data 2`` runs the sharded step on two virtual CPU devices; for
    mixtral, whose scatter dispatch takes one capacity over the whole
    batch, a step per data rank would differ, so it raises."""
    with pytest.raises(NotImplementedError, match="capacity"):
        train.run(["--arch", "mixtral-8x7b", "--reduced", "--device", "cpu",
                   "--data", "2", "--batch", "2", "--seq", "16",
                   "--steps", "1"])


def test_embedder_training_widens_the_gap():
    res = train_embedder.train(steps=100, device="cpu", log_every=0)
    (d0, n0), (d1, n1) = res["before"], res["after"]
    assert d1 - n1 > d0 - n0 and d1 - n1 > 0
    assert np.mean(res["losses"][-10:]) < np.mean(res["losses"][:10])


def test_embedder_wrap_step_runs_every_step_and_keeps_the_losses():
    """``train_embedder.train``'s ``wrap_step`` hook (chip_smoke times and
    traces the embedder's steps through it): called once a step, in order,
    and the losses are what it returns."""
    seen, returned = [], []

    def wrap(i, run):
        seen.append(i)
        returned.append(run())
        return returned[-1]
    res = train_embedder.train(steps=3, device="cpu", log_every=0,
                               wrap_step=wrap)
    assert seen == [0, 1, 2]
    assert res["losses"] == returned and all(np.isfinite(returned))


def test_prefill_and_decode_steps_are_lm_without_grad():
    cfg = get_config("qwen3-14b").reduced().replace(dtype="float32")
    p = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(1))
    c1 = lm.init_cache(cfg, 2, 8, device="cpu")
    c2 = lm.init_cache(cfg, 2, 8, device="cpu")
    p["embed"].requires_grad_(True)
    l1, c1 = steps.make_prefill_step(cfg)(p, {"tokens": toks}, c1)
    with torch.no_grad():
        l2, c2 = lm.prefill(p, cfg, {"tokens": toks}, c2)
    assert l1.grad_fn is None and torch.equal(l1, l2)
    d1, _ = steps.make_decode_step(cfg)(p, toks[:, :1], c1, 6,
                                        torch.full((2,), 7))
    with torch.no_grad():
        d2, _ = lm.decode_step(p, cfg, toks[:, :1], c2, 6,
                               torch.full((2,), 7))
    assert d1.grad_fn is None and torch.equal(d1, d2)
