"""Atomic checkpointing with retention + async write (port of
``repro/checkpoint/manager.py``; the same on-disk format).

Layout: <dir>/step_<N>/  (one .npz per top-level state key + MANIFEST)
Atomicity: write into step_<N>.tmp-<pid>, fsync, rename — readers never
see partial checkpoints; killed writers leave only .tmp dirs that the next
save() garbage-collects. SISO exposes state_dict()/load_state() and its
snapshots ride in here.

Async: save() can enqueue onto a writer thread so the serving loop never
blocks on disk; wait() drains before exit or restore.

The tree walk is plain Python over dicts, lists, tuples and NamedTuples;
leaves may be numpy arrays, Python scalars or torch tensors (copied to the
host). bf16 leaves are stored as a uint16 view under the reference's
``__bf16`` key tag and restore as CPU ``torch.bfloat16`` tensors, so each
package reads the other's files. A NamedTuple spec naming a class of the
reference package (``repro.…``) resolves to the port's counterpart
(``repro_torch.…``) when one exists and decays to a dict otherwise; a
restore never imports ``repro``, ``jax`` or ``ml_dtypes``.
"""
from __future__ import annotations

import importlib
import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

_BF16_TAG = "__bf16"   # bf16 leaves are stored as their uint16 view

# live tmp dirs older than this are presumed wedged and reclaimed even if
# their writer pid still exists (module attr so tests can shrink it)
TMP_GC_AGE_S = 3600.0

# a restore never imports these: the reference package maps to the port,
# the JAX stack decays to plain dicts
_REFERENCE_PKG, _PORT_PKG = "repro", "repro_torch"
_NEVER_IMPORT = ("jax", "jaxlib", "ml_dtypes")


def _is_bf16(v: Any) -> bool:
    return getattr(v, "dtype", None) == torch.bfloat16 or (
        isinstance(v, np.ndarray) and v.dtype.name == "bfloat16")


def _host_leaf(x: Any, copy: bool) -> Any:
    """One leaf on the host: numpy, or a CPU tensor for bf16 (numpy has no
    bf16 without ml_dtypes). ``copy`` detaches it from the live buffer."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.clone() if copy else t
        return t.numpy().copy() if copy else t.numpy()
    return np.array(x) if copy else np.asarray(x)


def _map_leaves(tree: Any, fn) -> Any:
    """The reference's ``jax.tree.map`` over the containers a state uses:
    dict keys come back sorted, None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(tree[k], fn) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return type(tree)(*(_map_leaves(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return fn(tree)


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Pytree -> flat {path: ndarray}; path segments joined by '/'. A bf16
    tensor stays a tensor (the writer stores its uint16 view)."""
    out: dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        if hasattr(tree, "_asdict"):        # NamedTuple
            out.update(_flatten(tree._asdict(), prefix))
        else:
            for i, v in enumerate(tree):
                out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        # bare-array state entry: "_root_" marks a leaf at the top level
        leaf = _host_leaf(tree, copy=False)
        out[prefix[:-1] if prefix else "_root_"] = leaf
    return out


def _tree_spec(tree: Any) -> Any:
    """JSON-serializable structure descriptor matching _flatten's walk,
    saved in the MANIFEST so restore() rebuilds the exact container types
    (lists, tuples, NamedTuples)."""
    if isinstance(tree, dict):
        return {"t": "dict", "k": {k: _tree_spec(v) for k, v in tree.items()}}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        cls = type(tree)
        return {"t": "namedtuple",
                "cls": f"{cls.__module__}:{cls.__qualname__}",
                "k": {k: _tree_spec(v) for k, v in tree._asdict().items()}}
    if isinstance(tree, (list, tuple)):
        return {"t": "tuple" if isinstance(tree, tuple) else "list",
                "c": [_tree_spec(v) for v in tree]}
    return {"t": "leaf"}


def _import_class(ref: str):
    """The class a NamedTuple spec names, or None (the fields then decay
    to a dict). ``repro.x:Cls`` resolves as ``repro_torch.x:Cls``; the JAX
    stack is never imported."""
    module, _, qualname = ref.partition(":")
    root = module.split(".")[0]
    if root in _NEVER_IMPORT:
        return None
    if root == _REFERENCE_PKG:
        module = _PORT_PKG + module[len(_REFERENCE_PKG):]
    try:
        obj = importlib.import_module(module)
        for part in qualname.split("."):
            obj = getattr(obj, part)
        return obj
    except (ImportError, AttributeError):
        return None


def _unflatten_spec(flat: dict[str, Any], spec: Any,
                    prefix: str = "") -> Any:
    t = spec["t"]
    if t == "leaf":
        return flat[prefix[:-1] if prefix else "_root_"]
    if t in ("list", "tuple"):
        seq = [_unflatten_spec(flat, s, f"{prefix}{i}/")
               for i, s in enumerate(spec["c"])]
        return tuple(seq) if t == "tuple" else seq
    fields = {k: _unflatten_spec(flat, s, f"{prefix}{k}/")
              for k, s in spec["k"].items()}
    if t == "namedtuple":
        cls = _import_class(spec["cls"])
        if cls is not None:
            return cls(**fields)
    return fields


def _unflatten(flat: dict[str, Any], spec: Any = None) -> Any:
    if spec is not None:
        return _unflatten_spec(flat, spec)
    # legacy checkpoint (no spec in the MANIFEST): rebuild nested dicts,
    # then recover sequences from all-numeric key sets in *numeric* order
    if set(flat) == {"_root_"}:
        return flat["_root_"]
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return _listify(tree)


def _listify(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[k] for k in sorted(node, key=int)]
    return node


def _bf16_bits(v: Any) -> np.ndarray:
    """The uint16 view a bf16 leaf is stored as."""
    if isinstance(v, torch.Tensor):
        return v.contiguous().view(torch.int16).numpy().view(np.uint16)
    return v.view(np.uint16)


def _bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True      # exists, owned by someone else
    return True


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = False):
        self.dir = directory
        self.keep = keep
        # steps retention must never reap, regardless of age: a caller
        # layering delta snapshots over a full one protects the newest
        # full step here, or the deltas would outlive their base
        self.protect: set[int] = set()
        os.makedirs(directory, exist_ok=True)
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if async_write:
            self._q = queue.Queue()
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------ api

    def save(self, step: int, state: dict[str, Any]) -> None:
        """state: {"siso": tree, "meta": dict, ...}"""
        # async: deep-copy in one traversal — a view would alias the
        # caller's live buffers (spill rows, LRU clocks, EMA scalars),
        # which keep mutating while the writer thread serializes. Sync
        # writes finish before the caller resumes, so views are safe.
        copy = self._q is not None
        host = _map_leaves(state, lambda x: _host_leaf(x, copy))
        if self._q is not None:
            self._q.put((step, host))
        else:
            self._write(step, host)

    def wait(self) -> None:
        if self._q is not None:
            self._q.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def restore(self, step: int,
                keys: Optional[list[str]] = None) -> dict[str, Any]:
        """Load a checkpoint; ``keys`` restricts to a subset of top-level
        state keys (e.g. just a small "meta" entry when a caller only
        needs to classify the snapshot before deciding to load it)."""
        path = self._step_dir(step)
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)
        specs = manifest.get("spec", {})
        out: dict[str, Any] = {}
        for key in manifest["keys"] if keys is None \
                else [k for k in manifest["keys"] if k in keys]:
            with np.load(os.path.join(path, f"{key}.npz")) as z:
                flat = {}
                for k in z.files:
                    if k.endswith(_BF16_TAG):
                        flat[k[: -len(_BF16_TAG)]] = _bf16_tensor(z[k])
                    else:
                        flat[k] = z[k]
                out[key] = _unflatten(flat, specs.get(key))
        return out

    def restore_latest(self) -> tuple[int, dict[str, Any]]:
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        return steps[-1], self.restore(steps[-1])

    def restore_entry(self, step: int, key: str) -> Any:
        """Load one top-level entry of a checkpoint, e.g. the tiny ``meta``
        head (kind + refresh epoch) that warm restart reads to classify
        snapshots before committing to a full load (DESIGN.md §12)."""
        return self.restore(step, keys=[key])[key]

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp") \
                    and "tmp-" not in name:
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(steps)

    # ------------------------------------------------------------- internal

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _gc_stale_tmp(self) -> None:
        """Reap tmp dirs left by *dead* writers only: a tmp dir is stale iff
        its writer pid no longer exists or it has not been touched for
        TMP_GC_AGE_S (a wedged writer). Live concurrent writers into the
        same directory are left alone."""
        now = time.time()
        for name in os.listdir(self.dir):
            if ".tmp-" not in name:
                continue
            path = os.path.join(self.dir, name)
            try:
                pid = int(name.rsplit(".tmp-", 1)[1])
            except ValueError:
                pid = None
            if pid is not None and pid != os.getpid() and _pid_alive(pid):
                try:
                    age = now - os.path.getmtime(path)
                except OSError:
                    continue          # vanished: its writer renamed it
                if age < TMP_GC_AGE_S:
                    continue          # live concurrent writer — hands off
            shutil.rmtree(path, ignore_errors=True)

    def _write(self, step: int, host: dict[str, Any]) -> None:
        final = self._step_dir(step)
        tmp = f"{final}.tmp-{os.getpid()}"
        self._gc_stale_tmp()
        os.makedirs(tmp, exist_ok=True)
        keys = sorted(host)
        for key in keys:
            flat = {}
            for k, v in _flatten(host[key]).items():
                if _is_bf16(v):
                    flat[k + _BF16_TAG] = _bf16_bits(v)
                else:
                    flat[k] = v
            path = os.path.join(tmp, f"{key}.npz")
            with open(path, "wb") as f:
                np.savez(f, **flat)
                f.flush()
                os.fsync(f.fileno())
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump({"step": step, "keys": keys,
                       "spec": {k: _tree_spec(host[k]) for k in keys}}, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._retain()

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            if s in self.protect:
                continue
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def _worker(self) -> None:
        while True:
            step, host = self._q.get()
            try:
                self._write(step, host)
            except BaseException as e:      # surfaced by the next wait()
                self._error = e
            finally:
                self._q.task_done()
