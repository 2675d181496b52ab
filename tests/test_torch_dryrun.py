"""The dry-run tools (``repro_torch.launch.{roofline,step_cost,dryrun}``)
and the kernels' meta routes, against the reference's
``repro/launch/{hlo_analysis,hlo_cost,steps}.py``.

* The wire model, ``Roofline`` and ``model_flops`` equal the reference's
  within rtol 1e-12, with the reference's TPU constants passed in.
* Every (arch, shape) cell's skip status and reason equal the
  reference's ``skip_reason``.
* FLOPs: a reduced train cell traced on meta with the attention forced
  onto its plain version matches ``hlo_cost.analyze`` of the reference's
  same step compiled on one CPU device, less one known difference: the
  port's chunked cross-entropy recomputes each chunk's logits in the
  backward (``torch.utils.checkpoint``), where the reference's scan
  saves them, so the port counts one more unembedding matmul, 2 B L d V
  FLOPs. Beyond that the two agree within rtol 1e-12 (both count each
  dot's 2 M N K exactly). On the kernel route the count is the plain one
  less the pairs each attention call's mask drops, worked out
  analytically below.
* ``run_cell`` gives ``ok`` for reduced mixtral and rwkv6 cells on the
  production meta mesh (MoE dispatch and WKV6 on meta).
* The meta routes leave the CPU routes and the MoE's outputs and counts
  the same bits: the MoE against its dispatch as it was, with
  ``torch.bincount``.
* A train cell's per-device peak (one data rank traced, the ring and
  AdamW's update modelled) equals device 0's live bytes counted through
  the whole sharded step on (2, 1) and (2, 2) meta meshes.
"""
import math
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS as J_ARCH_IDS
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import get_config as j_get_config
from repro.launch import hlo_analysis as H
from repro.launch import hlo_cost as HC
from repro_torch.configs.base import ARCH_IDS, SHAPES, ShapeConfig, \
    get_config
from repro_torch.kernels import meta
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.kernels.wkv6 import ref as wkv6_ref
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers
from repro_torch.training import optimizer as opt
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
META = torch.device("meta")
RTOL = 1e-12


def test_wire_model_matches_the_reference():
    for op in R.COLLECTIVES:
        for size in (1.0, 4096.0, 3.3e9):
            for g in (1, 2, 3, 16, 256):
                got = R.wire_bytes(op, size, g)
                want = HC._wire_bytes(op, size, g)
                assert math.isclose(got, want, rel_tol=RTOL), (op, size, g)
    # the reference's HLO parser applies the same table
    hlo = "\n".join([
        "%a = bf16[1024,512]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}",
        "%b = f32[64,8]{1,0} all-gather(%y), replica_groups=[16,16]<=[256]",
        "%c = f32[32]{0} reduce-scatter(%z), replica_groups={{0,1}}",
        "%d = bf16[8,8]{1,0} all-to-all(%w), replica_groups={{0,1,2}}",
        "%e = s8[100]{0} collective-permute(%v), source_target_pairs={{0,1}}",
    ])
    stats = H.collective_stats(hlo)
    want = {"all-reduce": R.wire_bytes("all-reduce", 1024 * 512 * 2, 4),
            "all-gather": R.wire_bytes("all-gather", 64 * 8 * 4, 16),
            "reduce-scatter": R.wire_bytes("reduce-scatter", 32 * 4, 2),
            "all-to-all": R.wire_bytes("all-to-all", 8 * 8 * 2, 3),
            "collective-permute": R.wire_bytes("collective-permute", 100,
                                               2)}
    for op, b in want.items():
        assert math.isclose(stats.bytes_by_op[op], b, rel_tol=RTOL), op
    with pytest.raises(ValueError):
        R.wire_bytes("all-sum", 1.0, 2)


def test_roofline_matches_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        f, b, c, mf, mb = (float(x) for x in rng.uniform(1e9, 1e16, 5))
        n = int(rng.integers(1, 512))
        peak = float(rng.uniform(1e9, 1e11))
        j = H.Roofline("a", "s", "m", f, b, c, mf, n,
                       peak_memory_bytes=peak, model_bytes_total=mb)
        t = R.Roofline("a", "s", "m", f, b, c, mf, n, peak_memory_bytes=peak,
                       model_bytes_total=mb, peak_flops=H.PEAK_FLOPS,
                       hbm_bw=H.HBM_BW, link_bw=H.ICI_BW)
        jd, td = j.to_dict(), t.to_dict()
        assert set(jd) == set(td)
        for k, v in jd.items():
            if isinstance(v, float):
                assert math.isclose(td[k], v, rel_tol=RTOL), k
            else:
                assert td[k] == v, k
    # the defaults are one H100 SXM's, from the serving engine's model
    from repro_torch.serving import engine
    t = R.Roofline("a", "s", "m", 1.0, 1.0, 1.0, 1.0, 1)
    assert (t.peak_flops, t.hbm_bw) == (engine.H100_BF16_FLOPS,
                                        engine.H100_HBM_BW)


def test_model_flops_match_the_reference():
    assert ARCH_IDS == J_ARCH_IDS and list(SHAPES) == list(J_SHAPES)
    for arch in ARCH_IDS:
        for name in SHAPES:
            for red in (False, True):
                cfg, jcfg = get_config(arch), j_get_config(arch)
                if red:
                    cfg, jcfg = cfg.reduced(), jcfg.reduced()
                got = R.model_flops(cfg, SHAPES[name])
                want = H.model_flops(jcfg, J_SHAPES[name])
                assert math.isclose(got, want, rel_tol=RTOL), (arch, name)


def test_every_cells_skip_matches_the_reference():
    from repro.launch import steps as JS
    for arch in ARCH_IDS:
        for name in SHAPES:
            want = JS.skip_reason(arch, name)
            assert S.skip_reason(arch, name) == want, (arch, name)
            if want:
                rec = D.run_cell(arch, name, None, "single")
                assert rec == {"arch": arch, "shape": name,
                               "mesh": "single", "status": "skip",
                               "reason": want}


# ---------------------------------------------------------------------------
# FLOPs against the reference's HLO cost model
# ---------------------------------------------------------------------------

B, L, CE = 2, 64, 16


def _ref_flops(arch: str) -> float:
    import jax
    from repro.configs.base import ShapeConfig as JShape
    from repro.launch import steps as JS
    jcfg = j_get_config(arch).reduced().replace(dtype="float32")
    shape = JShape("t", L, B, "train")
    params = JS.params_struct(jcfg)
    args = (params, JS.opt_struct(params), JS.batch_struct(jcfg, shape, True))
    step = JS.make_train_step(jcfg, 1, ce_chunk=CE)
    return HC.analyze(jax.jit(step).lower(*args).compile().as_text()).flops


def _port_flops(arch: str, plain: bool) -> dict:
    cfg = get_config(arch).reduced().replace(dtype="float32")
    saved = layers.flash_attention
    if plain:
        layers.flash_attention = layers.flash_attention_plain
    try:
        rec = D.run_cell(arch, "t", None, "one", S.CellPolicy(ce_chunk=CE),
                         cfg=cfg, shape=ShapeConfig("t", L, B, "train"))
    finally:
        layers.flash_attention = saved
    assert rec["status"] == "ok", rec.get("traceback")
    return rec


def _attention_calls(cfg):
    """(per-layer forward and backward FLOPs of the plain attention, the
    same of the kernel route) for one self-attention layer of the reduced
    causal cell: the plain version forms all L x L pairs (S, then P V;
    the backward dP, dV, dQ, dK from the saved P), the kernel the causal
    pairs within the window, if any (the backward recomputes S)."""
    if cfg.attn_kind == "mla":
        dq, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    else:
        dq = dv = cfg.head_dim
    H_ = cfg.n_heads
    full = L * L
    w = min(cfg.window or L, L)         # row i sees min(i + 1, w) keys
    pairs = w * (w + 1) // 2 + (L - w) * w
    assert pairs == meta.mask_pairs(L, L, True, cfg.window, 0, 0)
    plain = 2 * B * H_ * full * (dq + dv) + 2 * B * H_ * full * (2 * dq + 2 * dv)
    kern = 2 * B * H_ * pairs * (dq + dv) + 2 * B * H_ * pairs * (3 * dq + 2 * dv)
    return plain, kern


@pytest.mark.parametrize("arch", ["qwen3-14b", "mixtral-8x7b",
                                  "minicpm3-4b", "deepseek-v2-236b"])
def test_flops_match_the_reference_hlo_cost(arch):
    cfg = get_config(arch).reduced().replace(dtype="float32")
    want = _ref_flops(arch)
    plain = _port_flops(arch, plain=True)
    kern = _port_flops(arch, plain=False)
    recompute = 2 * B * L * cfg.d_model * cfg.padded_vocab
    assert math.isclose(plain["flops_per_device"] - recompute, want,
                        rel_tol=RTOL), (plain["flops_per_device"], want)
    p, k = _attention_calls(cfg)
    assert kern["flops_per_device"] == \
        plain["flops_per_device"] - cfg.n_layers * (p - k)
    by = kern["flops_by_op"]
    assert by["repro_torch.flash_attention_meta"] > 0
    assert by["repro_torch.flash_attention_bwd_meta"] > 0
    assert not any(k.startswith("repro_torch") for k in plain["flops_by_op"])


def test_mask_pairs_count_the_reference_mask():
    for Lq, Lkv in ((1, 1), (7, 7), (5, 19), (19, 5), (33, 64), (64, 33)):
        for causal in (True, False):
            for window in (None, 1, 3, 16):
                for prefix in (0, 1, 4, 40):
                    for off in (0, Lkv - Lq, 3):
                        m = fa_ref.attention_mask(
                            Lq, Lkv, causal=causal, window=window,
                            prefix_len=prefix, q_offset=off,
                            kv_valid_len=None, device="cpu")
                        assert meta.mask_pairs(Lq, Lkv, causal, window,
                                               prefix, off) == \
                            int(m.sum()), (Lq, Lkv, causal, window, prefix,
                                           off)


# ---------------------------------------------------------------------------
# run_cell on the production meta mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "rwkv6-7b"])
def test_run_cell_ok_on_the_production_mesh(arch):
    cfg = get_config(arch).reduced()
    mesh = D.meta_mesh()
    shapes = [ShapeConfig("train_4k", 64, 32, "train"),
              ShapeConfig("prefill_32k", 64, 2, "prefill"),
              ShapeConfig("decode_32k", 64, 4, "decode")]
    for shape in shapes:
        pol = S.CellPolicy(accum=2, moe_impl="shard_map") \
            if shape.kind == "train" else None
        rec = D.run_cell(arch, shape.name, mesh, "single", pol, cfg=cfg,
                         shape=shape)
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["flops_per_device"] > 0
        assert rec["live_bytes_per_device"] >= \
            rec["argument_bytes_per_device"] > 0
        if shape.kind == "train":
            # 16 data ranks: the weights gathered, the f32 gradient ringed
            assert rec["computing_devices"] == 16
            assert rec["collective_counts"]["all-reduce"] > 0
            assert rec["collective_counts"]["all-gather"] > 0
            kern = "wkv6" if arch == "rwkv6-7b" else "flash_attention"
            assert f"repro_torch.{kern}_bwd_meta" in rec["flops_by_op"]
    # the reference's scatter dispatch on 16 data ranks is an error cell
    if arch == "mixtral-8x7b":
        rec = D.run_cell(arch, "train_4k", mesh, "single",
                         S.CellPolicy(accum=2), cfg=cfg, shape=shapes[0])
        assert rec["status"] == "error"
        assert rec["error"].startswith("NotImplementedError")


def test_one_device_trace_counts_what_make_train_step_holds():
    """On one device the trace's peak holds the arguments, and the sharded
    step on a (1, 1) mesh counts the same FLOPs as ``make_train_step``."""
    cfg = get_config("qwen3-14b").reduced()
    shape = ShapeConfig("t", 64, 2, "train")
    one = D.run_cell("qwen3-14b", "t", None, "one", cfg=cfg, shape=shape)
    sh = D.run_cell("qwen3-14b", "t", make_host_mesh(1, 1, [META]), "1x1",
                    cfg=cfg, shape=shape)
    assert one["status"] == sh["status"] == "ok"
    assert one["flops_per_device"] == sh["flops_per_device"]
    n_params = sum(t.numel() * t.element_size() for t in
                   D.SC._tensors(S.params_struct(cfg)))
    # params + two f32 moments + the batch
    assert one["argument_bytes_per_device"] > n_params
    assert one["live_bytes_per_device"] > one["argument_bytes_per_device"]


class DeviceBytes(TorchDispatchMode):
    """Live bytes by device while the sharded step runs on a meta mesh,
    where every virtual device is the one meta device: each storage an op
    makes is charged to an owner, ``current`` where set (a data rank's
    ``rank_grads``, a ring hop's receiving rank, the device of the block
    AdamW updates), else the owner of the op's first input that has one
    (a rank's later work on its own tensors), else 0: the first data
    rank's device, where the step keeps its own (the losses, AdamW's
    scalars)."""

    def __init__(self, owners: dict):
        super().__init__()
        self.owner = dict(owners)           # storage key -> owner
        self.live: dict = {}
        self.peak: dict = {}
        self.current = None
        self._refs: dict = {}

    def charge(self, t: torch.Tensor, who) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.owner:
            return
        n = st.nbytes()
        self.owner[key] = who
        self.live[who] = self.live.get(who, 0) + n
        self.peak[who] = max(self.peak.get(who, 0), self.live[who])

        def freed(_, key=key, who=who, n=n):
            if self._refs.pop(key, None) is not None:
                self.live[who] -= n
                self.owner.pop(key, None)
        self._refs[key] = weakref.ref(st, freed)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        who = self.current
        if who is None:
            who = next((self.owner[k] for k in
                        (t.untyped_storage()._cdata
                         for t in D.SC._tensors((args, kwargs)))
                        if k in self.owner), 0)
        for t in D.SC._tensors(out):
            self.charge(t, who)
        return out


def first_device_peak(cfg, shape, mesh) -> tuple[int, int]:
    """(device 0's arguments, its peak of live bytes) through one sharded
    step on the meta ``mesh``, counted by ``DeviceBytes`` as distinct
    devices would hold them: a ring hop is a copy made on the next rank's
    device (``collectives._hop`` to a rank's own device is none on one
    meta device)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharded_train as ST
    pol = S.CellPolicy()
    specs = S.input_specs(cfg.name, shape.name, pol, cfg=cfg, shape=shape)
    step, in_sh, _, _ = S.cell_shardings(cfg.name, shape.name, mesh, pol,
                                         cfg=cfg, shape=shape)
    params = D.shd.place_tree(specs["params"], in_sh["params"])
    state = ST.init_placed_state(params, pol.moment_dtype)
    batch = {k: D.shd.device_put(v, in_sh["batch"][k])
             for k, v in specs["batch"].items()}
    owners = {}
    for x in D.SC.placed_leaves((params, state, batch)):
        for coord, key in x.keys():
            st = x.blocks[key].untyped_storage()._cdata
            if not any(coord.values()):
                owners[st] = 0
            else:
                owners.setdefault(st, "other")
    base = sum(x.blocks[key].untyped_storage().nbytes()
               for x in D.SC.placed_leaves((params, state, batch))
               for coord, key in x.keys() if not any(coord.values()))
    mode = DeviceBytes(owners)
    mode.live[0] = mode.peak[0] = base
    n = len(step.ranks)
    rank_grads, hop, update = step.rank_grads, C._hop, opt.update_leaf

    def owned(who, fn, *a):
        mode.current = who
        try:
            return fn(*a)
        finally:
            mode.current = None

    def copied_hop(chunk, device):
        who = (mode.owner[chunk.untyped_storage()._cdata] + 1) % n
        return owned(who, chunk.clone)

    def owned_update(path, pb, *a):
        who = mode.owner[pb.untyped_storage()._cdata]
        return owned(who, update, path, pb, *a)
    step.rank_grads = lambda p, b, r: owned(r, rank_grads, p, b, r)
    C._hop, opt.update_leaf = copied_hop, owned_update
    try:
        with mode:
            step(params, state, batch)
    finally:
        C._hop, opt.update_leaf = hop, update
    return base, mode.peak[0]


@pytest.mark.parametrize("data,model", [(2, 1), (2, 2)])
@pytest.mark.parametrize("arch,seq", [("qwen3-14b", 8), ("qwen3-14b", 64),
                                      ("rwkv6-7b", 8)])
def test_per_rank_peak_matches_the_first_devices_bytes(arch, seq, data,
                                                       model):
    """``run_cell``'s per-rank branch (one data rank's ``rank_grads``
    traced, then ``step_cost.ring_phase_peak`` and ``update_transient``:
    what every production train cell reports) against device 0's live
    bytes through the whole sharded step on a (data, model) meta mesh,
    counted device by device (``first_device_peak``): the same arguments
    and the same peak, to the step's scalars (1e-4). At 8 tokens the ring
    or AdamW's update sets the peak, at 64 the backward. The ring's model
    held the rank's bf16 gradient leaf past its f32 copy, which frees it:
    1.7% over at (2, 1)."""
    cfg = get_config(arch).reduced()
    shape = ShapeConfig("t", seq, 2, "train")
    mesh = make_host_mesh(data, model, [META] * (data * model))
    rec = D.run_cell(arch, "t", mesh, f"{data}x{model}", cfg=cfg,
                     shape=shape)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["computing_devices"] == data
    args, peak = first_device_peak(cfg, shape, mesh)
    assert rec["argument_bytes_per_device"] == args
    got = rec["live_bytes_per_device"]
    assert abs(got - peak) <= 1e-4 * peak, (got, peak)


def test_launch_modules_import_no_jax():
    probe = ("import sys, repro_torch.launch.dryrun, "
             "repro_torch.launch.roofline, repro_torch.launch.step_cost, "
             "repro_torch.launch.steps, repro_torch.launch.mesh, "
             "repro_torch.launch.train, repro_torch.launch.serve, "
             "repro_torch.launch.train_embedder; print(sorted(m for m in "
             "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", probe],
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_dryrun_cli_writes_one_json_per_cell(tmp_path):
    """The CLI on a skipped cell and the argument parsing (the full cells
    take minutes; ``run_cell`` is held above)."""
    rc = D.main(["--mesh", "both", "--arch", "qwen3-14b", "--shape",
                 "long_500k", "--out", str(tmp_path), "--quiet"])
    assert rc == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "qwen3-14b_long_500k_multi.json", "qwen3-14b_long_500k_single.json"]


# ---------------------------------------------------------------------------
# the meta routes: shapes and FLOPs; the CPU routes and the MoE unchanged
# ---------------------------------------------------------------------------


def _rand(*shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


def _meta(*ts):
    return [None if t is None else t.to(META) for t in ts]


@pytest.mark.parametrize("dq,dv,dtype", [(16, 16, torch.float32),
                                         (96, 64, torch.bfloat16),
                                         (32, 32, torch.bfloat16)])
def test_flash_attention_meta_route(dq, dv, dtype):
    Bq, Lq, Lk, Hq, Hk = 2, 37, 53, 4, 2
    q, k, v = _rand(Bq, Lq, Hq, dq, dtype=dtype), \
        _rand(Bq, Lk, Hk, dq, dtype=dtype, seed=1), \
        _rand(Bq, Lk, Hk, dv, dtype=dtype, seed=2)
    kw = dict(causal=True, window=9, prefix_len=3, q_offset=Lk - Lq)
    out = fa_ops.flash_attention(q, k, v, **kw)
    want = fa_ref.attention_ref(q, k, v, p_dtype=v.dtype, **kw)
    assert torch.equal(out, want)            # the CPU route, unchanged
    mq, mk, mv = _meta(q, k, v)
    with FlopCounterMode(display=False) as fc:
        mo = fa_ops.flash_attention(mq, mk, mv, **kw)
    assert mo.is_meta and mo.shape == out.shape and mo.dtype == out.dtype
    pairs = meta.mask_pairs(Lq, Lk, True, 9, 3, Lk - Lq)
    assert fc.get_total_flops() == 2 * Bq * Hq * pairs * (dq + dv)
    if fa_ops.saves_lse(dtype, dq, dv):
        o2, lse = fa_ops._forward(mq, mk, mv, True, 9, 3, Lk - Lq, None,
                                  with_lse=True)
        assert lse.shape == (Bq, Hq, fa_ref.lse_rows(Lq))
        assert lse.dtype == torch.float32
    # training: FlashAttentionFn's backward on meta, its FLOPs counted
    mq.requires_grad_(True)
    with FlopCounterMode(display=False) as fc:
        mo = fa_ops.flash_attention(mq, mk, mv, **kw)
        mo.float().sum().backward()
    assert mq.grad.shape == q.shape and mq.grad.dtype == dtype
    assert fc.get_total_flops() == 2 * Bq * Hq * pairs * (dq + dv) + \
        2 * Bq * Hq * pairs * (3 * dq + 2 * dv)
    # the model layer takes the wrapper on meta, never the plain version
    with FlopCounterMode(display=False) as fc:
        layers.flash_attention(*_meta(q, k, v), **kw)
    assert set(str(k) for k in fc.get_flop_counts()["Global"]) == \
        {"repro_torch.flash_attention_meta"}


def test_decode_attention_meta_route():
    q = _rand(3, 8, 32)
    kc, vc = _rand(3, 40, 2, 32, seed=1), _rand(3, 40, 2, 32, seed=2)
    kv_len = torch.tensor([1, 17, 40], dtype=torch.int32)
    out = da_ops.decode_attention(q, kc, vc, kv_len)
    assert torch.equal(out, da_ref.decode_attention_ref(q, kc, vc, kv_len))
    with FlopCounterMode(display=False) as fc:
        mo = da_ops.decode_attention(*_meta(q, kc, vc, kv_len))
    assert mo.is_meta and mo.shape == out.shape and mo.dtype == out.dtype
    assert fc.get_total_flops() == 2 * 3 * 8 * 40 * 64
    with FlopCounterMode(display=False) as fc:
        mo = layers.decode_attention(*_meta(q[:, None], kc, vc),
                                     kv_len=kv_len.to(META))
    assert mo.shape == (3, 1, 8, 32) and fc.get_total_flops() > 0


def test_wkv6_meta_route():
    Bw, Lw, Hw, K = 2, 37, 3, 16
    r, k, v = (_rand(Bw, Lw, Hw, K, seed=s) for s in range(3))
    w = torch.sigmoid(_rand(Bw, Lw, Hw, K, seed=3))
    u, st = _rand(Hw, K, seed=4), _rand(Bw, Hw, K, K, seed=5)
    y, s = wkv6_ops.wkv6(r, k, v, w, u, st)
    yr, sr = wkv6_ref.wkv6_ref(r, k, v, w, u, st)
    assert torch.equal(y, yr) and torch.equal(s, sr)
    ms = _meta(r, k, v, w, u, st)
    with FlopCounterMode(display=False) as fc:
        my, mst = wkv6_ops.wkv6(*ms)
    assert my.shape == y.shape and mst.shape == s.shape
    assert fc.get_total_flops() == Bw * Lw * Hw * (5 * K * K + 5 * K)
    _, _, ck = wkv6_ops._forward(*ms, ckpt=True)
    assert ck.shape == wkv6_ref.wkv6_ckpt_ref(k, v, w, st).shape
    for t in ms:
        t.requires_grad_(True)
    with FlopCounterMode(display=False) as fc:
        my, mst = wkv6_ops.wkv6(*ms)
        (my.sum() + mst.sum()).backward()
    assert [t.grad.shape for t in ms] == [t.shape for t in ms]
    assert fc.get_total_flops() == Bw * Lw * Hw * (5 * K * K + 5 * K) + \
        14 * Bw * Lw * Hw * K * K


def test_topk_meta_routes():
    from repro_torch.kernels.cosine_topk import ops as ctk
    q, c = _rand(4, 32), _rand(100, 32, seed=1)
    with FlopCounterMode(display=False) as fc:
        vals, idx, hit = ctk.cosine_topk(*_meta(q, c), k=3, return_hit=True)
    assert (vals.shape, idx.shape, hit.shape) == ((4, 3), (4, 3), (4,))
    assert (vals.dtype, idx.dtype) == (torch.float32, torch.int32)
    assert fc.get_total_flops() == 2 * 4 * 100 * 32
    v1, i1 = ctk.cosine_top1_local(*_meta(q, c))
    assert v1.shape == i1.shape == (4,)
    codes = torch.zeros((100, 32), dtype=torch.int8)
    vq, iq = ctk.cosine_topk_q8(*_meta(q, codes, torch.ones(100)), k=2)
    assert vq.shape == (4, 2)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q[None, :, None].to(META),
                               q[None, :, None], q[None, :, None])


def _moe_dispatch_bincount(p, cfg, xg, expert_lo=None):
    """``layers._moe_dispatch`` as it was, counting with ``torch.bincount``
    (no meta kernel): the new count must give the same bits."""
    G, T, d = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    E_loc = p["w_gate"].shape[0]
    C = layers.moe_capacity(cfg, T)
    dev = xg.device
    xt = xg.reshape(G * T, d)
    gates, idx, aux = layers.moe_gating((xt @ p["router"]).reshape(G, T, E),
                                        k)
    group = torch.arange(G, device=dev).repeat_interleave(T * k)
    flat_e = idx.reshape(-1)
    key = group * E + flat_e
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=G * E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(key)
    pos[order] = torch.arange(key.numel(), device=dev) - starts[key[order]]
    keep = pos < C
    le = flat_e
    if expert_lo is not None or E_loc != E:
        le = flat_e - (expert_lo or 0)
        keep = keep & (le >= 0) & (le < E_loc)
    slot = torch.where(keep, (le * G + group) * C + pos,
                       torch.full_like(pos, E_loc * G * C))
    x_rep = xt.repeat_interleave(k, dim=0)
    buf = torch.zeros((E_loc * G * C + 1, d), dtype=xg.dtype, device=dev)
    buf.index_add_(0, slot, x_rep)
    buf = buf[:-1].reshape(E_loc, G * C, d)
    y = layers._experts(p, cfg, buf)
    y_flat = torch.cat([y.reshape(E_loc * G * C, d),
                        torch.zeros((1, d), dtype=y.dtype, device=dev)])
    y_tok = y_flat[slot] * gates.reshape(-1, 1).to(y.dtype)
    out = y_tok.reshape(G * T, k, d).sum(dim=1)
    if cfg.n_shared_experts:
        out = out + layers.mlp(p["shared"], xt, cfg.act)
    return out.reshape(G, T, d), aux


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-236b"])
@pytest.mark.parametrize("cf", [8.0, 1.0, 0.25])
def test_moe_dispatch_same_bits_as_bincount(arch, cf):
    cfg = get_config(arch).reduced().replace(dtype="float32",
                                             capacity_factor=cf)
    p = layers.moe_init(torch.Generator().manual_seed(0), cfg,
                        torch.float32, "cpu")
    xg = _rand(3, 24, cfg.d_model, seed=7)
    for lo in (None, 0, 2):
        pl = p if lo is None else {
            **p, **{k: p[k][lo:lo + 2] for k in ("w_gate", "w_up",
                                                  "w_down")}}
        got = layers._moe_dispatch(pl, cfg, xg, lo)
        want = _moe_dispatch_bincount(pl, cfg, xg, lo)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the counts themselves, with empty bins
    key = torch.from_numpy(np.random.default_rng(1).integers(0, 40, 500))
    counts = torch.zeros(64, dtype=key.dtype).scatter_add_(
        0, key, torch.ones_like(key))
    assert torch.equal(counts, torch.bincount(key, minlength=64))
    # and on meta, where bincount has no kernel, the dispatch traces
    mo, maux = layers._moe_dispatch({k: v.to(META) if torch.is_tensor(v)
                                     else {kk: vv.to(META)
                                           for kk, vv in v.items()}
                                     for k, v in p.items()}, cfg,
                                    xg.to(META))
    assert mo.shape == xg.shape and mo.is_meta
