#!/usr/bin/env python3
"""Kernels of one CUDA source of the port, built from two source trees,
side by side: ptxas's registers, stack and spills, and the SASS
instructions that differ.

    python3 tools/sass_diff.py --a PARENT/src --b src --source wkv6.cu \
        --function _ZN3wkv8wkv6_fwdI13__nv_bfloat16Li64ELi32EEEvNS_4ArgsE \
        [--function ...] [--every]

Each tree's ``repro_torch/csrc/SOURCE`` is built once to a cubin with the
port's nvcc flags (``kernels/_build.py``) under ``build/sass_diff``. The
SASS of each ``--function`` (a mangled name, or a part of one that names
one function alone, such as ``bwd_dq_bf16ILi128ELi128ELb0E``) is read
with ``cuobjdump -sass``; constant-bank offsets and branch targets are
masked, so that a kernel whose parameters moved but whose code did not
compares equal. Prints, for each tree, the ptxas line and the
instruction count by opcode where they differ, then the number of
instructions that differ. ``--every`` compares every function the two
cubins share, and names those that one of them alone holds. Needs
``nvcc`` (the machine with the GPU).
"""
from __future__ import annotations

import argparse
import collections
import difflib
import functools
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def build(tree: Path, source: str, out: Path) -> str:
    """``tree``'s csrc/``source`` into the cubin ``out``; ptxas's report."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    csrc = tree / "repro_torch" / "csrc"
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    out.parent.mkdir(parents=True, exist_ok=True)
    p = subprocess.run([_build._nvcc(), *flags, "-cubin", "-I", str(csrc),
                        "-o", str(out), str(csrc / source)],
                       capture_output=True, text=True)
    if p.returncode:
        raise SystemExit(f"{tree}: nvcc exit {p.returncode}\n{p.stderr}")
    return p.stdout + p.stderr


@functools.lru_cache(maxsize=None)
def dump(cubin: Path) -> tuple[str, list[str]]:
    """``cuobjdump -sass`` of ``cubin`` and the mangled names it holds
    (read once a cubin)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    txt = subprocess.run([tool, "-sass", str(cubin)], capture_output=True,
                         text=True, check=True).stdout
    return txt, [line.split("Function :")[1].strip()
                 for line in txt.splitlines() if "Function :" in line]


def sass(cubin: Path, function: str) -> tuple[str, list[str]]:
    """The mangled name ``function`` names (itself, or the one name that
    holds it) and its instructions, constant offsets and targets masked."""
    txt, names = dump(cubin)
    hits = [n for n in names if n == function] or \
        [n for n in names if function in n]
    if len(hits) != 1:
        raise SystemExit(f"{cubin}: {function} names {hits}; the cubin has "
                         f"{names}")
    function = hits[0]
    out, on = [], False
    for line in txt.splitlines():
        if "Function :" in line:
            on = line.split("Function :")[1].strip() == function
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if on and m:
            ins = re.sub(r"c\[0x[0-9a-f]+\]\[0x[0-9a-f]+\]", "c[*][*]",
                         m.group(1))
            if opcode(ins).startswith(("BRA", "BSSY", "CALL", "JMP")):
                ins = re.sub(r"`?\(\.L_x_\d+\)|0x[0-9a-f]+", "*", ins)
            out.append(ins)
    if not out:
        raise SystemExit(f"{cubin}: no SASS for {function}; it has {names}")
    return function, out


def opcode(ins: str) -> str:
    """An instruction's opcode, past its predicate."""
    tok = ins.split()
    return tok[1] if tok[0].startswith("@") and len(tok) > 1 else tok[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, type=Path)
    ap.add_argument("--b", required=True, type=Path)
    ap.add_argument("--source", required=True)
    ap.add_argument("--function", action="append", default=[])
    ap.add_argument("--every", action="store_true")
    args = ap.parse_args()
    if not args.function and not args.every:
        ap.error("name a --function or give --every")
    sys.path.insert(0, str(ROOT))
    from tools.trace_kernels import ptxas_functions
    from concurrent.futures import ThreadPoolExecutor
    trees = {"a": args.a, "b": args.b}
    cubins = {key: ROOT / "build" / "sass_diff" / key /
              (args.source + ".cubin") for key in trees}
    with ThreadPoolExecutor(2) as pool:      # both builds at once
        built = {key: pool.submit(build, tree.resolve(), args.source,
                                  cubins[key]) for key, tree in trees.items()}
        reps = {key: ptxas_functions(f.result()) for key, f in built.items()}
    functions = list(args.function)
    if args.every:
        names = {key: set(dump(c)[1]) for key, c in cubins.items()}
        for key, other in (("a", "b"), ("b", "a")):
            for n in sorted(names[key] - names[other]):
                print(f"[sass] only in {key}: {n}")
        functions += sorted(names["a"] & names["b"])
    same = 0
    for function in functions:
        got = {}
        for key, tree in (("a", args.a), ("b", args.b)):
            name, got[key] = sass(cubins[key], function)
            print(f"[sass] {key} {tree}: {name}: ptxas "
                  f"{reps[key].get(name)}; {len(got[key])} instructions")
        ops = {k: collections.Counter(opcode(i) for i in v)
               for k, v in got.items()}
        moved = {o: (ops["a"][o], ops["b"][o]) for o in ops["a"] | ops["b"]
                 if ops["a"][o] != ops["b"][o]}
        print(f"[sass] opcodes whose count differs (a, b): "
              f"{dict(sorted(moved.items()))}")
        diff = 0
        if got["a"] != got["b"]:
            sm = difflib.SequenceMatcher(a=got["a"], b=got["b"],
                                         autojunk=False)
            diff = sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2
                       in sm.get_opcodes() if tag != "equal")
        print(f"[sass] {function}: {diff} instructions differ "
              f"({len(got['a'])} against {len(got['b'])})", flush=True)
        same += diff == 0
    print(f"[sass] {same} of {len(functions)} functions the same")
    return 0


if __name__ == "__main__":
    sys.exit(main())
