"""The port stands alone: importing ``repro_torch`` and every submodule
pulls in neither ``jax`` nor the reference package ``repro``, restoring a
checkpoint the reference wrote imports neither (nor ``ml_dtypes``), and
``chip_smoke.py`` refuses to run (non-zero exit, no result line) without a
CUDA device or outside a checkout."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _PROBE], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20 and bad == "[]", out.stdout


def test_chip_smoke_imports_no_jax_or_reference():
    src = (ROOT / "chip_smoke.py").read_text()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            mod = s.split()[1]
            assert not mod.startswith(("jax", "repro.")) and mod != "repro"


def test_chip_smoke_refuses_without_cuda_or_checkout(tmp_path):
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    out = subprocess.run([sys.executable, str(lone)], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout


_RESTORE_PROBE = r"""
import sys
from repro_torch.checkpoint import CheckpointManager
step, rec = CheckpointManager(sys.argv[1]).restore_latest()
opt, half = rec["opt"], rec["half"]
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro", "ml_dtypes")
             or m.startswith(("jax.", "jaxlib", "repro.", "ml_dtypes.")))
print(step, type(opt).__name__, sorted(opt), str(half.dtype),
      half.float().tolist(), bad)
"""


def test_restoring_a_reference_checkpoint_imports_no_jax(tmp_path):
    """A checkpoint the reference wrote, with a NamedTuple spec naming a
    ``repro.…`` class and a bf16 leaf, restores in the port without
    importing ``repro``, ``jax`` or ``ml_dtypes``: the class has no port
    counterpart, so its fields decay to a dict, and the bf16 leaf comes
    back as a torch bf16 tensor."""
    import ml_dtypes
    import numpy as np
    from repro.checkpoint import CheckpointManager
    from repro.training.optimizer import AdamWState
    state = {"opt": AdamWState(step=np.asarray(2), m={"w": np.ones(3)},
                               v={"w": np.zeros(3)}),
             "half": np.asarray([1.0, -0.5], np.float32).astype(
                 ml_dtypes.bfloat16)}
    CheckpointManager(str(tmp_path)).save(5, state)
    out = subprocess.run([sys.executable, "-c", _RESTORE_PROBE,
                          str(tmp_path)], env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == \
        "5 dict ['m', 'step', 'v'] torch.bfloat16 [1.0, -0.5] []", out.stdout
