"""The parallel training plane of the port held against the reference on
the CPU: ``distributed.sharding``'s specs (every leaf of every LM
configuration, fsdp on and off, ``expert_data``, the stacked layer axis
dropped), batch and cache specs, ``launch.steps``' structs, policies and
``cell_shardings``; placements and gathers; ``ring_allreduce_schedule``,
``compression`` and ``pipeline``; ``moe_apply_shard_map``; and the sharded
train step.

What needs the reference on several devices (``shard_map``, a sharded
``jit``) runs once, in one subprocess with 8 forced host devices and
meshes of Auto axes built there (``jax.make_mesh(..., axis_types=Auto)``:
the reference's own ``make_host_mesh`` builds Explicit axes on this jax,
which its ``dp_constrain`` rejects); it pickles its results. The port runs
the same inputs on virtual CPU devices (``[cpu] * N``).

Tolerances: f32 1e-5 (absolute, or of the largest |value| where said);
codes, masks, specs, shapes and ring sums exact.
"""
import itertools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import get_config as j_get_config
from repro.configs.base import list_configs
from repro.distributed import compression as jcomp
from repro.distributed import pipeline as jpipe
from repro.distributed import sharding as jshd
from repro.launch import steps as jsteps
from repro_torch import weights
from repro_torch.configs.base import get_config
from repro_torch.distributed import collectives, compression, pipeline
from repro_torch.distributed import sharded_train as st
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.training import optimizer as opt

torch.set_num_threads(2)

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")
ARCHS = [a for a in list_configs() if j_get_config(a).family != "embedder"]
SHAPE_NAMES = list(J_SHAPES)
SHAPES_KIND = {k: v.kind for k, v in J_SHAPES.items()}
MOE_ARCHS = ("mixtral-8x7b", "deepseek-v2-236b")
MOE_CASES = [(a, cf, m) for a in MOE_ARCHS for cf in (8.0, 1.0)
             for m in ((2, 4), (1, 8))]
STEP_ARCHS = ("qwen3-14b", "mixtral-8x7b")
RING_SHAPE = (13, 3)        # 13 rows over 8 ranks: 3 rows of padding

_REFERENCE = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro.compat import shard_map
from repro.configs.base import get_config
from repro.distributed import sharding as shd
from repro.distributed.collectives import ring_allreduce_schedule
from repro.distributed.compression import (compressed_psum,
                                           topk_psum_with_feedback)
from repro.launch.steps import make_train_step
from repro.models import layers as L, lm
from repro.training import optimizer as opt

host = lambda t: jax.tree.map(np.asarray, t)
def mesh_of(shape, names=("data", "model")):
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
out = {"moe": {}, "step": {}}
for arch in MOE_ARCHS:
    for cf in (8.0, 1.0):
        for shape in ((2, 4), (1, 8)):
            mesh = mesh_of(shape)
            L.set_shard_mesh(mesh)
            cfg = get_config(arch).reduced().replace(
                dtype="float32", moe_impl="shard_map", act_dp=("data",),
                capacity_factor=cf)
            p = L.moe_init(jax.random.PRNGKey(3), cfg, jnp.float32)
            x = np.random.default_rng(5).normal(
                size=(4, 16, cfg.d_model)).astype(np.float32)
            with mesh:
                y, aux = jax.jit(lambda p, x: L.moe_apply(p, cfg, x))(
                    p, jnp.asarray(x))
            out["moe"][(arch, cf, shape)] = dict(p=host(p), x=x,
                                                 y=np.asarray(y),
                                                 aux=np.asarray(aux))
L.set_shard_mesh(None)
for arch in STEP_ARCHS:
    mesh = mesh_of((2, 2))
    cfg = get_config(arch).reduced().replace(dtype="float32", n_layers=2,
                                             act_dp=("data",))
    if cfg.is_moe:
        cfg = cfg.replace(moe_impl="shard_map")
        L.set_shard_mesh(mesh)
    optc = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = lm.init_params(jax.random.PRNGKey(7), cfg)
    rng = np.random.default_rng(9)
    batch = {k: rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    pspecs = shd.param_specs(params, cfg, fsdp=True)
    step = jax.jit(make_train_step(cfg, optc=optc, ce_chunk=16),
                   in_shardings=(shd.named(mesh, pspecs),
                                 shd.named(mesh, shd.opt_state_specs(
                                     None, pspecs)),
                                 shd.named(mesh, shd.batch_specs(
                                     cfg, "train", ("data",)))))
    p0 = host(params)
    with mesh:
        p1, s1, met = step(params, opt.init_state(params),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    out["step"][arch] = dict(p0=p0, p1=host(p1), m1=host(s1.m),
                             v1=host(s1.v), batch=batch,
                             **{k: float(met[k]) for k in
                                ("loss", "grad_norm", "lr")})
    L.set_shard_mesh(None)
mesh = mesh_of((8,), ("x",))
rng = np.random.default_rng(11)
ring_in = rng.normal(size=(8,) + RING_SHAPE).astype(np.float32)
fn = shard_map(lambda x: ring_allreduce_schedule(x[0], "x")[None],
               mesh=mesh, in_specs=P("x"), out_specs=P("x"))
out["ring"] = (ring_in, np.asarray(fn(ring_in)))
mesh = mesh_of((8,), ("data",))
g = rng.normal(size=(8, 64)).astype(np.float32)
fn = shard_map(lambda x: compressed_psum({"g": x[0]}, "data")["g"][None],
               mesh=mesh, in_specs=P("data"), out_specs=P("data"))
out["compressed"] = (g, np.asarray(fn(g)))
r0 = (0.01 * rng.normal(size=(8, 300))).astype(np.float32)
g = rng.normal(size=(8, 300)).astype(np.float32)
def kern(x, r):
    m, nr = topk_psum_with_feedback({"g": x[0]}, {"g": r[0]}, "data",
                                    frac=0.05)
    return m["g"][None], nr["g"][None]
fn = shard_map(kern, mesh=mesh, in_specs=(P("data"), P("data")),
               out_specs=(P("data"), P("data")))
mean, res = fn(g, r0)
out["topk"] = (g, r0, np.asarray(mean), np.asarray(res))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module", autouse=True)
def _reference_run(tmp_path_factory):
    """The reference's multi-device run (one subprocess, 8 devices),
    started with this file's first test so that it overlaps the tests
    that need no reference results."""
    path = tmp_path_factory.mktemp("ref") / "ref.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    consts = (f"MOE_ARCHS = {MOE_ARCHS!r}\nSTEP_ARCHS = {STEP_ARCHS!r}\n"
              f"RING_SHAPE = {RING_SHAPE!r}\n")
    proc = subprocess.Popen([sys.executable, "-c", consts + _REFERENCE,
                             str(path)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def ref(_reference_run):
    """The reference's results, once its run has ended."""
    proc, path = _reference_run
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def cpus(n: int) -> list:
    return [CPU] * n


# ---------------------------------------------------------------------------
# specs, structs, policies
# ---------------------------------------------------------------------------


def _ref_specs(ps, specs) -> dict:
    """The reference's spec tree as {path in the port's layout: tuple},
    a stacked leaf's spec without its leading (layer) entry, each layer
    of the port's list under its own index."""
    from repro.compat import tree_flatten_with_path
    leaves = tree_flatten_with_path(ps)[0]
    flat = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    out = {}
    for (path, leaf), spec in zip(leaves, flat):
        keys = tuple(getattr(e, "key", getattr(e, "idx", None))
                     for e in path)
        spec = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        if keys[0] in ("blocks", "enc_blocks"):
            assert spec[0] is None
            for i in range(leaf.shape[0]):
                out[(keys[0], i) + keys[1:]] = spec[1:]
        else:
            out[keys] = spec
    return out


def _port_specs(ps, specs) -> dict:
    out = {}
    shd.tree_map_with_path(lambda path, leaf, spec: out.__setitem__(
        path, tuple(spec) + (None,) * (leaf.ndim - len(spec))), ps, specs)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch):
    """Every leaf's spec equals the reference's without the stacked
    layer axis, under fsdp on and off, expert_data and the multi-pod
    FSDP axes; the port's MoE experts (rank 3) take the MoE rule."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    ps, jps = steps.params_struct(cfg), jsteps.params_struct(jcfg)
    for fsdp, ed, axes in itertools.product(
            (True, False), (False, True), (("data",), ("pod", "data"))):
        got = _port_specs(ps, shd.param_specs(ps, cfg, fsdp, ed, axes))
        want = _ref_specs(jps, jshd.param_specs(jps, jcfg, fsdp, ed, axes))
        assert got == want, (fsdp, ed, axes)
    if cfg.is_moe and cfg.n_experts % 16 == 0:
        # experts over "model": the MoE rule, not the _COL rule's
        # (None, "data", "model") that a rank-3 leaf would get by name
        w = shd.param_specs(ps, cfg, fsdp=True)["blocks"][0]["mlp"]
        assert w["w_gate"] == shd.P("model", None, "data")


def test_moe_expert_rule_divisibility():
    """As the reference's test (``tests/test_distributed.py:47``): every
    sharded dim of the port's specs divides by its mesh axes (16, pod 2)."""
    sizes = {"data": 16, "model": 16, "pod": 2}
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        ps = steps.params_struct(cfg)
        combos = [(True, False), (False, False)]
        if cfg.n_experts % 16 == 0:
            combos.append((False, True))
        for fsdp, ed in combos:
            specs = shd.param_specs(ps, cfg, fsdp=fsdp, expert_data=ed)
            for (_, leaf), (_, spec) in zip(opt.tree_leaves(ps),
                                            opt.tree_leaves(specs)):
                for dim, ax in enumerate(spec):
                    if ax is None:
                        continue
                    axes = ax if isinstance(ax, tuple) else (ax,)
                    n = int(np.prod([sizes[a] for a in axes]))
                    assert leaf.shape[dim] % n == 0, (arch, leaf.shape, spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for dp in (("data",), ("pod", "data"), ()):
        for kind in ("train", "prefill", "decode"):
            got = shd.batch_specs(cfg, kind, dp)
            want = jshd.batch_specs(jcfg, kind, dp)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}
        for seq_shard, seq_axes in ((False, None), (True, None),
                                    (False, ("data", "model")),
                                    (False, ("model",))):
            got = shd.cache_specs(cfg, dp, seq_shard, seq_axes)
            want = jshd.cache_specs(jcfg, dp, seq_shard, seq_axes)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}


def _flat_shapes(tree) -> list:
    return [(tuple(x.shape), str(x.dtype).split(".")[-1])
            for _, x in opt.tree_leaves(tree)]


def _ref_flat_shapes(tree) -> list:
    """The reference's struct leaves in the port's layout and order (dict
    keys sorted; a stacked collection one layer after another)."""
    out = []

    def walk(node, key=None):
        if isinstance(node, dict):
            for k in sorted(node):
                if k in ("blocks", "enc_blocks"):
                    n = jax.tree.leaves(node[k])[0].shape[0]
                    for i in range(n):
                        walk(jax.tree.map(lambda a: jax.ShapeDtypeStruct(
                            a.shape[1:], a.dtype), node[k]))
                else:
                    walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            out.append((tuple(node.shape), str(node.dtype)))
    walk(tree)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_structs_match_the_reference(arch):
    """``params_struct``, ``opt_struct`` and every cell's ``input_specs``:
    the same shapes and dtypes as the reference's ``jax.eval_shape`` ones,
    on the meta device."""
    cfg = get_config(arch)
    ps = steps.params_struct(cfg)
    assert all(x.device.type == "meta" for _, x in opt.tree_leaves(ps))
    assert lm.n_params(ps) == sum(int(np.prod(s)) for s, _ in
                                  _ref_flat_shapes(jsteps.params_struct(
                                      j_get_config(arch))))
    for name in SHAPE_NAMES:
        for pol in (None, steps.optimized_policy(arch, name)):
            jpol = None if pol is None else \
                jsteps.optimized_policy(arch, name)
            got = steps.input_specs(arch, name, pol)
            want = jsteps.input_specs(arch, name, jpol)
            assert sorted(got) == sorted(want)
            for k in got:
                g = got[k]
                w = want[k]
                if k == "opt_state":
                    assert g.step == 0
                    g, w = [g.m, g.v], [w.m, w.v]
                assert _flat_shapes(g) == _ref_flat_shapes(w), (name, k)


def test_policies_match_the_reference():
    for arch, name in itertools.product(ARCHS, SHAPE_NAMES):
        for f, jf in ((steps.cell_policy, jsteps.cell_policy),
                      (steps.optimized_policy, jsteps.optimized_policy)):
            got, want = f(arch, name), jf(arch, name)
            assert vars(got) == vars(want), (arch, name)
        assert steps.skip_reason(arch, name) == \
            jsteps.skip_reason(arch, name)
    steps.set_override("qwen3-14b", "train_4k", accum=3)
    jsteps.set_override("qwen3-14b", "train_4k", accum=3)
    try:
        assert steps.cell_policy("qwen3-14b", "train_4k").accum == \
            jsteps.cell_policy("qwen3-14b", "train_4k").accum == 3
    finally:
        steps._OVERRIDES.clear()
        jsteps._OVERRIDES.clear()


def _named_specs(tree) -> list:
    return [tuple(s.spec) for _, s in opt.tree_leaves(tree)]


def _ref_named_specs(tree, like) -> list:
    flat = jax.tree.leaves(tree, is_leaf=lambda x: hasattr(x, "spec"))
    leaves = jax.tree.leaves(like)
    out = []
    for s, leaf in zip(flat, leaves):
        out.append(tuple(s.spec) + (None,) * (len(leaf.shape)
                                              - len(s.spec)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_shardings_match_the_reference(arch):
    """Every cell's in and out placements, as specs, and its donated
    arguments, under the default and the optimized policy: the
    reference's on a (1, 1) mesh of Auto axes, the port's on the
    production (16, 16) mesh of virtual devices (no spec depends on the
    sizes here: every sharded batch divides by 16)."""
    from jax.sharding import AxisType
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)
    meshes = (make_production_mesh(devices=[torch.device("meta")] * 256),)
    try:
        for name in SHAPE_NAMES:
            pols = [None]
            if (arch, name) in steps.OPTIMIZED:
                pols.append(steps.optimized_policy(arch, name))
            for pol in pols:
                jpol = None if pol is None else \
                    jsteps.optimized_policy(arch, name)
                _, jin, jout, jdon = jsteps.cell_shardings(arch, name, jmesh,
                                                           jpol)
                jspecs = jsteps.input_specs(arch, name, jpol)
                for mesh in meshes:
                    step, tin, tout, tdon = steps.cell_shardings(
                        arch, name, mesh, pol)
                    assert tdon == jdon and sorted(tin) == sorted(jin)
                    specs = steps.input_specs(arch, name, pol)
                    for k in tin:
                        if k not in ("params", "opt_state"):
                            t, j = tin[k], jin[k]
                            if not isinstance(t, dict):
                                t, j = {k: t}, {k: j}
                            for kk in t:
                                assert _named_specs(t[kk]) == \
                                    _ref_named_specs(j[kk], (
                                        jspecs[k][kk] if len(t) > 1 or
                                        isinstance(jspecs[k], dict)
                                        else jspecs[k])), (name, k, kk)
                            continue
                        trees = [(specs[k], tin[k], jspecs[k], jin[k])]
                        if k == "opt_state":
                            assert tuple(tin[k].step.spec) == ()
                            trees = [(t.m, ti.m, j.m, ji.m) for t, ti, j, ji
                                     in trees] + [(t.v, ti.v, j.v, ji.v)
                                                  for t, ti, j, ji in trees]
                        for t, ti, j, ji in trees:
                            got = _port_specs(t, shd.tree_map(
                                lambda s: s.spec, ti))
                            want = _ref_specs(j, jax.tree.map(
                                lambda s: s.spec, ji,
                                is_leaf=lambda x: hasattr(x, "spec")))
                            assert got == want, (name, k)
                    if SHAPES_KIND[name] != "train":
                        assert tuple(tout[0].spec) == tuple(jout[0].spec)
                    if SHAPES_KIND[name] == "train":
                        assert isinstance(step, st.ShardedTrainStep)
    finally:
        from repro.models.layers import set_shard_mesh as j_set_shard_mesh
        L.set_shard_mesh(None)
        j_set_shard_mesh(None)



# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------


def test_placements_split_uneven_dims_and_gather_exactly():
    """Blocks of ceil(n / k) rows, the last short or empty; one copy of a
    block per distinct device; the gather returns the same bits."""
    x = torch.randn(10, 7, dtype=torch.float64).to(torch.bfloat16)
    mesh = make_host_mesh(2, 4, devices=cpus(8))
    for spec, n_blocks in ((shd.P("model", "data"), 8), (shd.P("data"), 2),
                           (shd.P(None, "model"), 4), (shd.P(), 1),
                           (shd.P(("data", "model")), 6)):  # 3 empty
        placed = shd.device_put(x, shd.NamedSharding(mesh, spec))
        assert len(placed.blocks) == n_blocks, spec
        assert torch.equal(shd.gather(placed).view(torch.int16),
                           x.view(torch.int16))
        for coord, _ in placed.keys():
            b = placed.block(**coord)
            sl = shd.block_slices(x.shape, mesh, spec, coord)
            assert torch.equal(b, x[sl])
    # 7 columns over 4: blocks of 2, 2, 2, 1
    placed = shd.device_put(x, shd.NamedSharding(mesh, shd.P(None, "model")))
    assert [placed.block(model=m).shape[1] for m in range(4)] == [2, 2, 2, 1]
    # 10 rows over 8: blocks of 2, the last three empty
    placed = shd.device_put(x, shd.NamedSharding(
        mesh, shd.P(("data", "model"))))
    rows = [placed.block(data=d, model=m).shape[0]
            for d in range(2) for m in range(4)]
    assert rows == [2, 2, 2, 2, 2, 0, 0, 0]
    # distinct devices keep their own copies
    two = Mesh(np.array([[torch.device("cpu"), torch.device("meta")]],
                        dtype=object), ("data", "model"))
    placed = shd.device_put(x, shd.NamedSharding(two, shd.P("data")))
    assert len(placed.blocks) == 2 and placed.blocks[
        next(k for k in placed.blocks if k[0].type == "meta")].is_meta


def test_host_mesh_clamps_like_the_reference():
    assert dict(make_host_mesh(2, 2, devices=cpus(1)).shape) == \
        {"data": 1, "model": 1}
    assert dict(make_host_mesh(4, 4, devices=cpus(8)).shape) == \
        {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        make_production_mesh(devices=cpus(8))
    mesh = make_production_mesh(multi_pod=True, devices=cpus(512))
    assert dict(mesh.shape) == {"pod": 2, "data": 16, "model": 16}


# ---------------------------------------------------------------------------
# collectives and compression
# ---------------------------------------------------------------------------


def test_ring_allreduce_matches_the_reference(ref):
    """An odd length (13 rows over 8 ranks): each rank's sum is the
    reference ring's, bit for bit, and the same on every rank."""
    x, want = ref["ring"]
    got = collectives.ring_allreduce_schedule(
        [torch.from_numpy(x[r]) for r in range(8)])
    for r in range(8):
        assert torch.equal(got[r], got[0])
        np.testing.assert_array_equal(got[r].numpy(), want[r])
    np.testing.assert_allclose(got[0].numpy(), x.sum(0), atol=1e-5)


@pytest.mark.parametrize("world", [1, 2, 3, 5])
def test_ring_allreduce_sums_any_world(world):
    xs = [torch.arange(7 * 2, dtype=torch.int32).reshape(7, 2) * (r + 1)
          for r in range(world)]
    out = collectives.ring_allreduce_schedule(xs)
    want = sum(xs[1:], xs[0])
    assert all(torch.equal(o, want) for o in out)


def test_quantize_int8_codes_match_the_reference():
    rng = np.random.default_rng(2)
    for x in (rng.normal(size=(37, 5)).astype(np.float32),
              np.zeros((4,), np.float32),
              np.array([0.5, -1.5, 2.5, 127.0, -127.0], np.float32)):
        q, s = compression.quantize_int8(torch.from_numpy(x))
        jq, js = jcomp.quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_array_equal(
            compression.dequantize_int8(q, s).numpy(),
            np.asarray(jcomp.dequantize_int8(jq, js)))


def test_compressed_psum_matches_the_reference(ref):
    g, want = ref["compressed"]
    got = compression.compressed_psum(
        [{"g": torch.from_numpy(g[r])} for r in range(8)])
    for r in range(8):
        np.testing.assert_array_equal(got[r]["g"].numpy(), want[r])
    exact = g.mean(axis=0)
    assert float(compression.relative_error(
        torch.from_numpy(exact), got[0]["g"])) < 0.05


def test_topk_masks_with_ties_match_the_reference():
    """Ties at the threshold are all kept, as the reference's ``>=``; the
    bisection's threshold equals ``torch.topk``'s and the reference's."""
    rng = np.random.default_rng(3)
    x = rng.integers(-6, 7, size=(41, 3)).astype(np.float32)   # many ties
    y = rng.normal(size=(257,)).astype(np.float32)
    for arr in (x, y, -np.abs(y)):
        for frac in (0.001, 0.05, 0.3, 1.0):
            kept, res = compression.topk_sparsify(torch.from_numpy(arr),
                                                  frac)
            jk, jr = jcomp.topk_sparsify(jnp.asarray(arr), frac)
            np.testing.assert_array_equal(kept.numpy(), np.asarray(jk))
            np.testing.assert_array_equal(res.numpy(), np.asarray(jr))
            flat = torch.from_numpy(arr).reshape(-1)
            k = max(1, int(frac * flat.numel()))
            assert float(compression.kth_largest_abs(flat, k)) == \
                float(torch.topk(flat.abs(), k).values[-1])


def test_topk_psum_with_feedback_matches_the_reference(ref):
    g, r0, want_mean, want_res = ref["topk"]
    mean, res = compression.topk_psum_with_feedback(
        [{"g": torch.from_numpy(g[r])} for r in range(8)],
        [{"g": torch.from_numpy(r0[r])} for r in range(8)], frac=0.05)
    for r in range(8):
        np.testing.assert_allclose(mean[r]["g"].numpy(), want_mean[r],
                                   atol=1e-6)
        assert torch.equal(mean[r]["g"], mean[0]["g"])
        np.testing.assert_array_equal(res[r]["g"].numpy(), want_res[r])
        kept, _ = compression.topk_sparsify(
            torch.from_numpy(g[r] + r0[r]), 0.05)
        assert torch.equal(kept + res[r]["g"], torch.from_numpy(g[r] + r0[r]))
    z = compression.init_residuals({"a": torch.ones(2, 3, dtype=torch.bfloat16)})
    assert z["a"].dtype == torch.float32 and not z["a"].any()


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def test_stage_spans_and_bubble_match_the_reference():
    for n, s in itertools.product(range(1, 13), range(1, 9)):
        assert pipeline.stage_spans(n, s) == jpipe.stage_spans(n, s)
        assert pipeline.bubble_fraction(s, n) == jpipe.bubble_fraction(s, n)


@pytest.mark.parametrize("S,M", list(itertools.product((1, 2, 4),
                                                       (1, 2, 4))))
def test_pipeline_matches_the_sequential_forward(S, M):
    """The reference test's tanh stack: S stages of one 16 x 16 layer on
    S virtual devices, M microbatches, against the layer loop."""
    rng = np.random.default_rng(0)
    ws = torch.from_numpy(rng.normal(size=(S, 16, 16)).astype(np.float32)
                          * 0.3)
    x = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    mesh = Mesh(np.array(cpus(S), dtype=object), ("stage",))
    out = pipeline.pipeline_forward(lambda w, xm: torch.tanh(xm @ w),
                                     list(ws), x, mesh=mesh,
                                     n_microbatches=M)
    want = x
    for s in range(S):
        want = torch.tanh(want @ ws[s])
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5)


def test_pipeline_of_reduced_qwen3_blocks_matches_the_block_loop():
    """A reduced qwen3's 4 blocks split by ``stage_spans(4, S)`` over S
    virtual stages, 4 microbatches, against the blocks run in order on the
    whole batch (f32, 1e-5)."""
    cfg = get_config("qwen3-14b").reduced().replace(dtype="float32",
                                                    n_layers=4)
    params = lm.init_params(torch.Generator().manual_seed(1), cfg, CPU)
    x = torch.randn(4, 24, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    pos = torch.arange(24)

    def run(blocks, h):
        for bp in blocks:
            h = lm._block(bp, cfg, h, lambda a, bp=bp: L.gqa_attend(
                bp["attn"], cfg, a, pos, causal=True))
        return h
    with torch.no_grad():
        want = run(params["blocks"], x)
        for S in (2, 4):
            spans = pipeline.stage_spans(4, S)
            mesh = Mesh(np.array(cpus(S), dtype=object), ("stage",))
            got = pipeline.pipeline_forward(
                run, [params["blocks"][a:b] for a, b in spans], x,
                mesh=mesh, n_microbatches=4)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_pipeline_fault_misroutes_a_microbatch(monkeypatch):
    """A microbatch sent past the next stage skips a stage's layers: the
    output differs from the sequential one (what chip_smoke's planted
    fault relies on)."""
    calls = []

    def wrong(s, mb):
        calls.append((s, mb))
        return s + 2 if (s, mb) == (0, 0) else s + 1
    monkeypatch.setattr(pipeline, "_downstream", wrong)
    ws = [torch.full((4, 4), 0.5) for _ in range(3)]
    x = torch.ones(4, 4)
    mesh = Mesh(np.array(cpus(3), dtype=object), ("stage",))
    out = pipeline.pipeline_forward(lambda w, xm: torch.tanh(xm @ w), ws, x,
                                    mesh=mesh, n_microbatches=2)
    want = x
    for w in ws:
        want = torch.tanh(want @ w)
    assert not torch.allclose(out[:2], want[:2])
    assert torch.allclose(out[2:], want[2:])


# ---------------------------------------------------------------------------
# the MoE dispatch per shard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,cf,shape", MOE_CASES)
def test_moe_shard_map_matches_the_reference(ref, arch, cf, shape):
    """Reduced mixtral and deepseek-v2 (4 experts), capacity 8.0 and 1.0
    (tokens dropped), on (2, 4) (expert parallel) and (1, 8) (the ffn
    sliced): the output and aux loss within 1e-5 of the reference's
    ``shard_map``, and equal to ``moe_apply(..., groups=data)``."""
    r = ref["moe"][(arch, cf, shape)]
    cfg = get_config(arch).reduced().replace(
        dtype="float32", moe_impl="shard_map", act_dp=("data",),
        capacity_factor=cf)
    p = weights.to_torch(r["p"], CPU)
    x = torch.from_numpy(r["x"])
    mesh = make_host_mesh(*shape, devices=cpus(shape[0] * shape[1]))
    L.set_shard_mesh(mesh)
    try:
        y, aux = L.moe_apply(p, cfg, x)
    finally:
        L.set_shard_mesh(None)
    np.testing.assert_allclose(y.numpy(), r["y"], atol=1e-5)
    np.testing.assert_allclose(float(aux), float(r["aux"]), atol=1e-6)
    gy, gaux = L.moe_apply(p, cfg.replace(moe_impl="scatter"), x,
                           groups=shape[0])
    np.testing.assert_allclose(y.numpy(), gy.numpy(), atol=1e-5)
    if cf == 1.0:       # tokens were dropped: one dispatch would differ
        one, _ = L.moe_apply(p, cfg.replace(moe_impl="scatter"), x)
        assert shape[0] == 1 or not torch.allclose(one, y, atol=1e-5)


def test_moe_shard_map_without_a_mesh_is_the_scatter_dispatch():
    cfg = get_config("mixtral-8x7b").reduced().replace(dtype="float32")
    p = L.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32, CPU)
    x = torch.randn(2, 8, cfg.d_model)
    want = L.moe_apply(p, cfg, x)
    L.set_shard_mesh(None)
    got = L.moe_apply(p, cfg.replace(moe_impl="shard_map", act_dp=("data",)),
                      x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------


def _leaves(tree, jtree, cfg) -> list:
    want = weights.convert_lm(jtree, cfg, device=CPU)
    pairs = list(zip(opt.tree_leaves(tree), opt.tree_leaves(want)))
    assert [p for (p, _), _ in pairs] == [p for _, (p, _) in pairs]
    return [(path, g, w) for (path, g), (_, w) in pairs]


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_sharded_step_matches_the_reference(ref, arch):
    """Reduced f32 qwen3 and mixtral (``moe_impl="shard_map"``) at 2
    layers, global batch 4 x 32 on a (2, 2) mesh of virtual CPU devices,
    one step against the reference's sharded step: the loss, grad norm and
    learning rate within 1e-5 (relative); the moments (the gradient and
    its square, scaled) within 1e-5 of each leaf's largest; the params
    within 1e-5 wherever the gradient is at least 1e-4 of its leaf's
    largest. AdamW's first update is g / (|g| + eps) entry by entry, so
    where g sits at the rounding level of the gradient sums it moves by up
    to lr in either package: there the params are held to 2 lr."""
    r = ref["step"][arch]
    cfg = get_config(arch).reduced().replace(dtype="float32", n_layers=2)
    if cfg.is_moe:
        cfg = cfg.replace(moe_impl="shard_map")
    mesh = make_host_mesh(2, 2, devices=cpus(4))
    params = st.place_params(weights.convert_lm(r["p0"], cfg, device=CPU),
                             cfg, mesh)
    state = st.init_placed_state(params)
    batch = st.place_batch({k: torch.from_numpy(v)
                            for k, v in r["batch"].items()}, cfg, mesh)
    optc = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = st.make_sharded_train_step(cfg, mesh, optc=optc, ce_chunk=16)
    params, state, met = step(params, state, batch)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(met[k]), r[k], rtol=1e-5)
    p1, s1 = st.gather_state(params, state)
    for name, tree in (("m1", s1.m), ("v1", s1.v)):
        for path, g, w in _leaves(tree, r[name], cfg):
            err, top = float((g - w).abs().max()), float(w.abs().max())
            assert err <= 1e-5 * top, (name, path, err, top)
    for (path, p, w), (_, _, m) in zip(_leaves(p1, r["p1"], cfg),
                                       _leaves(s1.m, r["m1"], cfg)):
        err = (p - w).abs()
        sure = m.abs() >= 1e-4 * m.abs().max()
        assert float((err * sure).max()) <= 1e-5, path
        assert float(err.max()) <= 2 * optc.lr, path
    assert s1.step == 1


@pytest.mark.parametrize("arch,accum", [("qwen3-14b", 1), ("qwen3-14b", 2),
                                        ("mixtral-8x7b", 1)])
def test_sharded_step_on_one_device_is_make_train_step(arch, accum):
    """On a (1, 1) mesh two steps are ``make_train_step``'s bit for bit:
    loss, grad norm, params and moments (bf16 params, f32 moments)."""
    cfg = get_config(arch).reduced()
    params = lm.init_params(torch.Generator().manual_seed(3), cfg, CPU)
    optc = opt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    mesh = make_host_mesh(1, 1, devices=cpus(1))
    placed = st.place_params(params, cfg, mesh)
    pstate = st.init_placed_state(placed)
    state = opt.init_state(params)
    one = steps.make_train_step(cfg, accum=accum, optc=optc, ce_chunk=16)
    sharded = st.make_sharded_train_step(cfg, mesh, accum=accum, optc=optc,
                                         ce_chunk=16)
    rng = np.random.default_rng(4)
    for _ in range(2):
        b = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
        params, state, m1 = one(params, state, b)
        placed, pstate, m2 = sharded(placed, pstate,
                                     st.place_batch(b, cfg, mesh))
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(torch.as_tensor(m1[k]), torch.as_tensor(m2[k]))
    got, gstate = st.gather_state(placed, pstate)
    for a, b in ((got, params), (gstate.m, state.m), (gstate.v, state.v)):
        for (path, x), (_, y) in zip(opt.tree_leaves(a), opt.tree_leaves(b)):
            assert x.dtype == y.dtype and torch.equal(x, y), path


def test_sharded_step_with_accum_and_pods_matches_one_device():
    """A (pod 2, data 2, model 1) mesh with 2 microbatches a rank: the
    reference's microbatch grouping, so the f32 step equals the one-device
    step with accum 2 within 1e-5."""
    cfg = get_config("qwen3-14b").reduced().replace(dtype="float32")
    params = lm.init_params(torch.Generator().manual_seed(5), cfg, CPU)
    optc = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    mesh = Mesh(np.array(cpus(4), dtype=object).reshape(2, 2, 1),
                ("pod", "data", "model"))
    placed = st.place_params(params, cfg, mesh, fsdp_axes=("pod", "data"))
    pstate = st.init_placed_state(placed)
    rng = np.random.default_rng(6)
    b = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 16))
                             .astype(np.int32)) for k in ("tokens", "labels")}
    placed, pstate, m2 = st.make_sharded_train_step(
        cfg, mesh, accum=2, optc=optc, ce_chunk=16)(
        placed, pstate, st.place_batch(b, cfg, mesh))
    state = opt.init_state(params)
    params, state, m1 = steps.make_train_step(cfg, accum=2, optc=optc,
                                              ce_chunk=16)(params, state, b)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]),
                               rtol=1e-5)
    got, _ = st.gather_state(placed, pstate)
    for (path, x), (_, y) in zip(opt.tree_leaves(got),
                                 opt.tree_leaves(params)):
        assert float((x - y).abs().max()) <= 1e-5, path


def test_sharded_step_raises_for_a_whole_batch_moe_capacity():
    cfg = get_config("mixtral-8x7b").reduced().replace(dtype="float32")
    mesh = make_host_mesh(2, 1, devices=cpus(2))
    params = st.place_params(lm.init_params(torch.Generator().manual_seed(0),
                                            cfg, CPU), cfg, mesh)
    b = {k: torch.zeros(2, 8, dtype=torch.int32) for k in ("tokens",
                                                           "labels")}
    with pytest.raises(NotImplementedError, match="capacity"):
        st.make_sharded_train_step(cfg, mesh)(
            params, st.init_placed_state(params),
            st.place_batch(b, cfg, mesh))


def test_train_module_runs_on_a_data_mesh():
    """``python -m repro_torch.launch.train --data 2 --model 1`` runs (on
    two virtual CPU devices here; one card gives (1, 1)), prints its mesh,
    and ``--grad-compression`` is accepted and unused."""
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu",
         "--data", "2", "--model", "1", "--grad-compression"],
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "2"},
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "mesh: Mesh(data=2, model=1" in run.stdout
    assert sum(line.startswith("step ") for line in
               run.stdout.splitlines()) == 2
