#!/usr/bin/env python3
"""Time edited copies of the attention backward
(``csrc/flash_attention_bwd.cu``: the bf16 wgmma pairs, or with ``--f32``
the f32 CUDA-core pair) beside the tree they come from: the design
alternatives behind PERF.md's findings on the wide pair, on what the
ragged ``kv_valid_len`` costs the pair up to 128, and on the f32 pair.

    python3 tools/bwd_variants.py [--src DIR] [--iters N]
                                  [--calls qwen3,minicpm3,paligemma,deepseek]
                                  [--lens 4096,...] [--f32 [--rounds N]]
                                  NAME [NAME ...]

Each NAME copies ``DIR/repro_torch`` (default: this checkout's ``src``)
into ``build/bwd_variants/TREE-NAME/src`` (TREE: the name of ``DIR``'s
parent directory), applies that variant's text edits to
its ``flash_attention_bwd.cu`` (each must match exactly once, or the run
stops) and builds the library there, unless a library of that source is
there from an earlier run; the builds start together. A NAME given twice
runs twice on one build. Then, in
a process of its own for each variant (two libraries that define kernels
of one name cannot share a process), it holds the variant against
``ref.attention_bwd_ref`` at 600 tokens (the bf16 row limit of the tests,
``kernels.bf16_excess``) and times (a) and (b) apart through
``kernel.launch_bwd`` at ``--calls`` of CALLS, B 1 x each of ``--lens``
tokens (default 4,096), causal (device ms a call, the mean
of ``--iters``
under ``torch.profiler``, ``tools/trace_kernels.py``'s
``device_kernel_ms``), the variants one after another in the order given.
The name ``base`` takes the tree unedited. Needs one CUDA card.

Variants: ``dq-bk32``, (a) at <192, 128> with 32-key tiles (as at <256,
256>) instead of 64; ``dkv-one``, (b) at <256, 256> with one CTA a key
tile where the tree splits dK's and dV's columns across two CTAs (half
the CTAs at paligemma's one kv head, 2/3 of the products);
``dkv-split``, (b) at <256, 256> with dK's and dV's columns split across
two CTAs at every grid;
``ragged-always``, the pair up to 128 in its instance with
kv_valid_len (the test of each tile against the end of its row's keys)
for every call, as before the instance without it was added;
``groupN``, the exact-width pair <96, 64>'s CTAs in groups of N
(sequence, head) pairs instead of 8 (``GROUP_BH``; ``group4096`` holds every head in one group, the tile the
slowest index, as the other instances order them); ``dq-nopipeline``,
its (a) with S and dP issued and waited for, then dQ, instead of tile
j's S and dP issued with tile j - 1's dQ;
``dkv-nopipeline``, its (b) in two turns a tile, each waited for,
instead of one turn that issues tile j's S^T and dP^T with tile j - 1's
dV and dK; ``nopipeline``, both; ``stages4``, every ring four
stages deep instead of three (the exact pair's calls alone are timed).

A call of the exact-width class (minicpm3's (96, 64)) is timed as the
training path runs it: (a) from the LSE that K4's training forward wrote
(part 3), then (b).

``--f32`` times the f32 tiled pair instead, at ``--calls`` in f32 (default
qwen3's 40/8 heads of 128 at ``--lens`` 1,024 tokens, causal: phase 13
(a)'s timed call) beside the pair as it was before its Hopper redesign
(``tools/attention_bwd_f32_parent.cu``, built by ``parent_f32_entry``), in
``--rounds`` rounds of alternating order (variant, parent; then parent,
variant), after holding both against ``ref.attention_bwd_ref`` at 300
tokens (1e-5 of the largest |gradient|). Its variants: ``f32-light-first``,
the grids with the tile their fastest index (the parent's order) instead
of the heaviest causal tiles first; ``f32-unroll1``, the score products'
chunk loop not unrolled in (b) and in (a) at head dim 128 (the timed
instances), where the tree unrolls it 2 deep.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

DQ_BK32 = [(
    "  return Tiles<DQP, DVP, TR>::DQ_SMEM <= SMEM_MAX ? TR : TR / 2;",
    "  return TR / 2;                          // variant: 32-key tiles")]

SPLIT_TEST = ("  *split = grid.x * grid.y * grid.z * 100 <= SPLIT_PCT * "
              "(unsigned)sms ? 2 : 1;")
DKV_ONE = [(SPLIT_TEST, "  *split = 1;   // variant: never split")]
DKV_SPLIT = [(SPLIT_TEST, "  *split = 2;   // variant: always split")]

RAGGED_ALWAYS = [(
    "  return a.kvl ? run_pair<DQP, DVP, true>(a, part, s)\n"
    "               : run_pair<DQP, DVP, false>(a, part, s);",
    "  return run_pair<DQP, DVP, true>(a, part, s);   // variant")]

GROUP = "constexpr int GROUP_BH = 8;"
DQ_NOPIPELINE = [("constexpr bool DQ_PIPELINE = true;",
                  "constexpr bool DQ_PIPELINE = false;   // variant")]
DKV_NOPIPELINE = [("constexpr bool DKV_PIPELINE = true;",
                   "constexpr bool DKV_PIPELINE = false;   // variant")]

F32_LIGHT_FIRST = [("constexpr bool F32_HEAVY_FIRST = true;",
                    "constexpr bool F32_HEAVY_FIRST = false;")]
F32_UNROLL1 = [("  static constexpr int UNR_A = DP == 128 ? 2 : 1;\n"
                "  static constexpr int UNR_B = 2;",
                "  static constexpr int UNR_A = 1;\n"
                "  static constexpr int UNR_B = 1;")]

VARIANTS = {"base": [], "dq-bk32": DQ_BK32, "dkv-one": DKV_ONE,
            "dkv-split": DKV_SPLIT, "ragged-always": RAGGED_ALWAYS,
            "dq-nopipeline": DQ_NOPIPELINE,
            "dkv-nopipeline": DKV_NOPIPELINE,
            "nopipeline": DQ_NOPIPELINE + DKV_NOPIPELINE,
            "stages4": [("constexpr int STAGES = 3;  ",
                         "constexpr int STAGES = 4;  // variant  ")],
            **{f"group{n}": [(GROUP, f"constexpr int GROUP_BH = {n};")]
               for n in (1, 4, 16, 4096)},
            "f32-light-first": F32_LIGHT_FIRST, "f32-unroll1": F32_UNROLL1}

# (label, H, Hkv, Dq, Dv, prefix_len), B 1 x 4,096, causal
CALLS = {"qwen3": ("qwen3-14b", 40, 8, 128, 128, 0),
         "minicpm3": ("minicpm3-4b", 40, 40, 96, 64, 0),
         "paligemma": ("paligemma-3b", 8, 1, 256, 256, 256),
         "deepseek": ("deepseek-v2-236b", 128, 128, 192, 128, 0)}


PARENT_F32 = ROOT / "tools" / "attention_bwd_f32_parent.cu"
_loaded: dict = {}


def parent_f32_entry():
    """The C entry of the f32 pair before its redesign
    (``flash_attention_bwd_f32_parent``, the port's argument list), built
    on first use beside the port's libraries: (function, ptxas report, or
    None where an earlier run built it)."""
    import ctypes
    import hashlib
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from tools.wkv6_bwd_probe import _nvcc
    if "parent_f32" in _loaded:
        return _loaded["parent_f32"], None
    h = hashlib.sha256(PARENT_F32.read_bytes())
    h.update(" ".join(_build.NVCC_FLAGS).encode())
    lib = _build.BUILD_DIR / \
        f"libattention_bwd_f32_parent-{h.hexdigest()[:16]}.so"
    report = None if lib.exists() else _nvcc(PARENT_F32, lib)
    fn = ctypes.CDLL(str(lib)).flash_attention_bwd_f32_parent
    fn.argtypes = _build.KERNELS["flash_attention_bwd"][2]
    fn.restype = ctypes.c_int
    _loaded["parent_f32"] = fn
    return fn, report


def launch_parent_f32(torch, fn, q, k, v, o, do, dq, dk, dv, lse, dsum, *,
                      causal: bool, window: int, prefix_len: int,
                      q_offset: int, part: int) -> None:
    """Part 0 ((a)) or 1 ((b)) of the parent's f32 pair on the port's
    tensors, as ``kernel.launch_bwd`` passes them (lse and dsum from
    ``kernel.bwd_scratch``; its LSE is in natural-log units, so its (b)
    reads only its own (a)'s scratch)."""
    B, Lq, H, D = q.shape
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), 0, B, Lq, k.shape[1], H,
            k.shape[2], D, v.shape[3], D, int(causal), window, prefix_len,
            q_offset, 0, part, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention_bwd_f32_parent: CUDA error {rc}")


def make(name: str, src: Path) -> Path:
    """The variant's tree under build/bwd_variants/TREE-NAME/src."""
    dst = ROOT / "build" / "bwd_variants" / f"{src.parent.name}-{name}" / \
        "src"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "repro_torch" / "csrc" / "flash_attention_bwd.cu"
    text = cu.read_text()
    for old, new in VARIANTS[name]:
        n = text.count(old)
        if n != 1:
            raise SystemExit(f"{name}: an edit matches {n} times, not once: "
                             f"{old[:60]!r}")
        text = text.replace(old, new)
    cu.write_text(text)
    return dst


def build(dst: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         "from repro_torch.kernels import _build;"
         "print(_build.build(['flash_attention_bwd'])"
         ".get('flash_attention_bwd', ''))", str(dst)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


RUN = """
import sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import torch
from repro_torch.kernels import bf16_excess
from repro_torch.kernels.flash_attention import kernel as K, ops, ref
from tools.trace_kernels import device_kernel_ms
name, iters, calls, lens = sys.argv[3], int(sys.argv[4]), %r, %r
g = torch.Generator(device="cuda").manual_seed(0)


def inputs(L, H, Hkv, Dq, Dv, prefix):
    q = torch.randn((1, L, H, Dq), generator=g, device="cuda").bfloat16()
    k = torch.randn((1, L, Hkv, Dq), generator=g, device="cuda").bfloat16()
    v = torch.randn((1, L, Hkv, Dv), generator=g, device="cuda").bfloat16()
    lse = None
    if ops.saves_lse(q.dtype, Dq, Dv):      # K4's training forward
        o, lse = ops._forward(q, k, v, True, None, prefix, 0, None,
                              with_lse=True)
    else:
        o = ref.attention_ref(q, k, v, causal=True, prefix_len=prefix,
                              p_dtype=v.dtype).contiguous()
    do = torch.randn(o.shape, generator=g, device="cuda").bfloat16()
    return q, k, v, o, do, lse


for label, H, Hkv, Dq, Dv, prefix in calls:
    kw = dict(causal=True, prefix_len=prefix)
    *xs, lse = inputs(600, min(H, 16), min(Hkv, 16), Dq, Dv, prefix)
    got = ops.flash_attention_bwd(*xs, lse=lse, **kw)
    plain = ref.attention_bwd_ref(*xs, **kw)
    rss = ref.attention_bwd_rss(*xs, **kw)
    share = max(bf16_excess(a, b, 2.0 ** -5, scale=r)
                for a, b, r in zip(got, plain, rss))
    for L in lens:
        q, k, v, o, do, saved = inputs(L, H, Hkv, Dq, Dv, prefix)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        lse, dsum = K.bwd_scratch(q)
        if saved is not None:
            lse = saved
        ms, kern = {}, {}
        for part, what in ((0 if saved is None else 3, "a"), (1, "b")):
            own = device_kernel_ms(torch, lambda: K.launch_bwd(
                q, k, v, o, do, dq, dk, dv, lse, dsum, causal=True, window=0,
                prefix_len=prefix, q_offset=0, part=part), iters)[0]
            ms[what] = sum(own.values())
            kern[what] = ", ".join(n.split("(")[0].replace("void ", "")
                                   for n in own)
        print(f"[variant] {name} {label} B 1 x {L}, {H}/{Hkv} heads of "
              f"{Dq}/{Dv}, prefix {prefix}: (a) {ms['a']:.4f} ms, (b) "
              f"{ms['b']:.4f} ms ({kern['a']}; {kern['b']}), the pair "
              f"{ms['a'] + ms['b']:.4f} ms; at 600 tokens {share:.3f} of "
              f"the bf16 row limit", flush=True)
        del q, k, v, o, do, dq, dk, dv, lse, dsum, saved
        torch.cuda.empty_cache()
"""


RUN_F32 = """
import statistics
import sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import torch
from repro_torch.kernels.flash_attention import kernel as K, ops, ref
from tools.trace_kernels import device_kernel_ms
from tools.bwd_variants import launch_parent_f32, parent_f32_entry
name, iters, calls, lens, rounds = (sys.argv[3], int(sys.argv[4]), %r, %r,
                                    %r)
g = torch.Generator(device="cuda").manual_seed(0)
parent, report = parent_f32_entry()
for line in (report or "").splitlines():
    if "registers" in line or "spill" in line:
        print(f"[build] parent: {line.strip()}", flush=True)


def inputs(L, H, Hkv, Dq, Dv, prefix):
    q = torch.randn((1, L, H, Dq), generator=g, device="cuda")
    k = torch.randn((1, L, Hkv, Dq), generator=g, device="cuda")
    v = torch.randn((1, L, Hkv, Dv), generator=g, device="cuda")
    o = ref.attention_ref(q, k, v, causal=True,
                          prefix_len=prefix).contiguous()
    do = torch.randn(o.shape, generator=g, device="cuda")
    return q, k, v, o, do


def pair(fn, xs, kw):
    q, k, v, o, do = xs
    outs = [torch.empty_like(x) for x in (q, k, v)]
    lse, dsum = K.bwd_scratch(q)
    calls = [lambda part=part: fn(*xs, *outs, lse, dsum, part=part, **kw)
             for part in (0, 1)]
    return outs, calls


def new(*args, **kw):
    K.launch_bwd(*args, **kw)


def old(*args, **kw):
    launch_parent_f32(torch, parent, *args, **kw)


for label, H, Hkv, Dq, Dv, prefix in calls:
    kw = dict(causal=True, window=0, prefix_len=prefix, q_offset=0)
    xs = inputs(300, min(H, 16), min(Hkv, 16), Dq, Dv, prefix)
    plain = ref.attention_bwd_ref(*xs, causal=True, prefix_len=prefix)
    share = {}
    for who, fn in (("variant", new), ("parent", old)):
        outs, run = pair(fn, xs, kw)
        for c in run:
            c()
        torch.cuda.synchronize()
        share[who] = max(float((a - b).abs().max()) / (1e-5 * float(
            b.abs().max())) for a, b in zip(outs, plain))
    for L in lens:
        xs = inputs(L, H, Hkv, Dq, Dv, prefix)
        runs = {"variant": pair(new, xs, kw)[1], "parent": pair(old, xs, kw)[1]}
        for c in runs["variant"] + runs["parent"]:
            c()
        got = {(w, p): [] for w in runs for p in "ab"}
        kern = {}
        for r in range(rounds):
            order = ("variant", "parent") if r %% 2 == 0 else \\
                ("parent", "variant")
            for who in order:
                for part, what in zip((0, 1), "ab"):
                    own = device_kernel_ms(torch, runs[who][part], iters)[0]
                    got[(who, what)].append(sum(own.values()))
                    kern[(who, what)] = ", ".join(
                        n.split("(")[0].replace("void ", "") for n in own)
        med = {key: statistics.median(t) for key, t in got.items()}
        for who in ("variant", "parent"):
            print(f"[variant] {name} f32 {label} B 1 x {L}, {H}/{Hkv} heads "
                  f"of {Dq}/{Dv}, prefix {prefix}: {who} (a) "
                  f"{med[(who, 'a')]:.4f} ms, (b) {med[(who, 'b')]:.4f} ms "
                  f"({kern[(who, 'a')]}; {kern[(who, 'b')]}), the pair "
                  f"{med[(who, 'a')] + med[(who, 'b')]:.4f} ms (medians of "
                  f"{rounds}: (a) {got[(who, 'a')]}, (b) {got[(who, 'b')]});"
                  f" at 300 tokens {share[who]:.3f} of the f32 limit",
                  flush=True)
        del xs, runs
        torch.cuda.empty_cache()
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="+", choices=sorted(VARIANTS))
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--calls", default=None)
    ap.add_argument("--lens", default=None)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if args.calls is None:
        args.calls = "qwen3" if args.f32 else ",".join(CALLS)
    calls = tuple(CALLS[c] for c in args.calls.split(","))
    lens = tuple(int(x) for x in (
        args.lens or ("1024" if args.f32 else "4096")).split(","))
    trees = {n: make(n, Path(args.src).resolve()) for n in set(args.names)}
    procs = {n: build(d) for n, d in trees.items()}
    for n, p in procs.items():
        report = p.communicate()[0]
        if p.returncode:
            print(f"[variant] {n}: the build failed\n{report}", flush=True)
            return 1
        fn = ""
        for line in report.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line
            elif ("wgmma" in line or (
                    ("_dq_f32I" in fn or "_dkv_f32I" in fn) if args.f32
                    else ("wide" in fn or "Li96E" in fn))) and (
                    "spill" in line or "registers" in line):
                print(f"[build] {n}: {fn[:40]}: {line.strip()}", flush=True)
    run = RUN_F32 % (calls, lens, args.rounds) if args.f32 else \
        RUN % (calls, lens)
    for n in args.names:
        rc = subprocess.run([sys.executable, "-c", run,
                             str(trees[n]), str(ROOT), n,
                             str(args.iters)]).returncode
        if rc:
            print(f"[variant] {n}: exit {rc}", flush=True)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
