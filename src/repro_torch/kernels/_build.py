"""Build and bind every hand-written Hopper kernel of the port.

The CUDA sources live in ``repro_torch/csrc``. Each ``.cu`` file is built
by its own ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, loaded with ``ctypes``. Libraries are named by a hash of their
sources and land in ``build/kernels`` at the repository root (listed in
``.gitignore``), so a checkout builds them at first use and a rebuilt
source never loads a stale library. All builds start together.

Every kernel package registers its C entry points in ``KERNELS`` below.
Nothing here runs at import time: this module is imported on machines
without ``nvcc`` or a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# library stem -> (source, C entry point, argtypes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
KERNELS = {
    "cosine_topk": ("cosine_topk.cu", "cosine_topk_f32",
                    [_P] * 8 + [_I] * 5 + [_F, _I, _P]),
    "cosine_topk_q8": ("cosine_topk_q8.cu", "cosine_topk_q8",
                       [_P] * 9 + [_I] * 5 + [_F, _I, _P]),
    # 29 int64 packed into one bytes argument (flash_attention.cu)
    "flash_attention": ("flash_attention.cu", "flash_attention",
                        [ctypes.c_char_p, _P]),
    "decode_attention": ("decode_attention.cu", "decode_attention",
                         [_P] * 10 + [_L] * 21 + [_P]),
    "wkv6": ("wkv6.cu", "wkv6", [_P] * 9 + [_L] * 12 + [_I] * 5 + [_P]),
    "flash_attention_bwd": ("flash_attention_bwd.cu", "flash_attention_bwd",
                            [_P] * 11 + [_L] * 14 + [_P]),
    "wkv6_bwd": ("wkv6_bwd.cu", "wkv6_bwd",
                 [_P] * 14 + [_L] * 12 + [_I] * 5 + [_P]),
}

_loaded: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU")


def _lib_path(name: str) -> Path:
    src = CSRC / KERNELS[name][0]
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Build the named kernels (default: all) that have no library yet, one
    ``nvcc`` process per source, all started together. Returns
    {name: ptxas report} for the ones built now."""
    names = list(KERNELS) if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / KERNELS[n][0])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True),
                    tmp, out)
    reports, errors = {}, []
    for n, (p, tmp, out) in procs.items():
        stdout, stderr = p.communicate()
        if p.returncode != 0:
            errors.append(f"{n}: nvcc exit {p.returncode}\n{stderr}")
            continue
        os.replace(tmp, out)
        reports[n] = stdout + stderr
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return reports


def load(name: str) -> ctypes._CFuncPtr:
    """The C entry point of kernel ``name``, built on first use."""
    fn = _loaded.get(name)
    if fn is None:
        build([name])
        _, sym, argtypes = KERNELS[name]
        fn = getattr(ctypes.CDLL(str(_lib_path(name))), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def entry(name: str, sym: str) -> ctypes._CFuncPtr:
    """Another C entry point ``sym`` of kernel ``name``'s library, with the
    registered entry's argument types (a probe that no wrapper routes to),
    built on first use."""
    fn = _loaded.get(f"{name}:{sym}")
    if fn is None:
        load(name)
        _, _, argtypes = KERNELS[name]
        fn = getattr(ctypes.CDLL(str(_lib_path(name))), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[f"{name}:{sym}"] = fn
    return fn


def check_rc(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error at launch."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
