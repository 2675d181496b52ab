"""The forward route of the prefill attention (K4) on the CPU:
``ops.fwd_route`` names the kernel instance a CUDA call takes, as
``csrc/flash_attention.cu``'s ``flash_attention`` dispatches it (bf16
zamba2's (112, 112) and the MLA pairs on ``flash_bf16_persistent`` at
exact widths, the pairs that pad alike on ``flash_bf16``, f32 on
``flash_f32``); ``ops.dv_supported`` accepts exactly the (Dq, Dv) pairs
it accepted before the persistent template came, every one of them has a
route, and the routes are the instances the C dispatch launches. No
kernel runs here: the routes are read from the wrapper and the source.
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops

torch.set_num_threads(2)

CSRC = (Path(fa_ops.__file__).resolve().parents[2] / "csrc"
        / "flash_attention.cu")
BF16 = torch.bfloat16


def _old_dv_supported(Dq: int, Dv: int) -> bool:
    """The pairs the kernels took before: both pad alike to 64, 128 or 256,
    or Dq <= 128 with Dv <= 64, or Dq <= 192 with Dv <= 128."""
    def pad(d):
        return 64 if d <= 64 else 128 if d <= 128 else 256
    pq, pv = pad(Dq), pad(Dv)
    return pq == pv or (pq == 128 and pv == 64) or (pv == 128 and Dq <= 192)


@pytest.mark.parametrize("dtype,Dq,Dv,route", [
    (BF16, 96, 64, "flash_bf16_persistent<96, 64, 192>"),      # minicpm3
    (BF16, 192, 128, "flash_bf16_persistent<192, 128, 96>"),   # deepseek-v2
    (BF16, 112, 112, "flash_bf16_persistent<112, 112, 128>"),  # zamba2
    (BF16, 72, 48, "flash_bf16_persistent<96, 64, 192>"),
    (BF16, 80, 48, "flash_bf16_persistent<96, 64, 192>"),
    (BF16, 96, 8, "flash_bf16_persistent<96, 64, 192>"),
    (BF16, 128, 64, "flash_bf16_persistent<192, 128, 96>"),
    (BF16, 104, 64, "flash_bf16_persistent<192, 128, 96>"),
    (BF16, 32, 128, "flash_bf16_persistent<192, 128, 96>"),
    (BF16, 136, 72, "flash_bf16_persistent<192, 128, 96>"),
    (BF16, 128, 128, "flash_bf16<128, 128, 128>"),              # qwen3
    (BF16, 112, 104, "flash_bf16<128, 128, 128>"),
    (BF16, 104, 104, "flash_bf16<128, 128, 128>"),
    (BF16, 64, 64, "flash_bf16<64, 64, 128>"),
    (BF16, 16, 48, "flash_bf16<64, 64, 128>"),
    (BF16, 256, 256, "flash_bf16<256, 256, 64>"),               # paligemma
    (BF16, 200, 136, "flash_bf16<256, 256, 64>"),
    (torch.float32, 96, 64, "flash_f32"),
    (torch.float32, 112, 112, "flash_f32"),
    (torch.float32, 64, 64, "flash_f32"),
    (BF16, 200, 128, ValueError),
    (BF16, 256, 64, ValueError),
    (BF16, 64, 256, ValueError),
    (BF16, 0, 64, ValueError),
    (BF16, 96, 257, ValueError),
], ids=lambda x: x.__name__ if isinstance(x, type)
   else str(x).replace("torch.", "").replace(" ", ""))
def test_fwd_route(dtype, Dq, Dv, route):
    """Each pair's instance; a pair no instance takes raises."""
    if isinstance(route, type):
        with pytest.raises(route):
            fa_ops.fwd_route(dtype, Dq, Dv)
    else:
        assert fa_ops.fwd_route(dtype, Dq, Dv) == route


def test_dv_supported_accepts_the_pairs_it_accepted_before():
    """No pair is newly refused or newly taken: every (Dq, Dv) in [1,
    256]^2 against the old rule."""
    for Dq in range(1, 257):
        for Dv in range(1, 257):
            assert fa_ops.dv_supported(Dq, Dv) == _old_dv_supported(Dq, Dv), \
                (Dq, Dv)


def _c_dispatch_instances() -> set:
    """The bf16 instances ``extern "C" flash_attention`` launches, read
    from the source."""
    src = CSRC.read_text()
    body = src[src.index('extern "C" int flash_attention('):]
    body = body[:body.index("\n}\n")]
    return {f"flash_bf16{'_persistent' if kind == 'persistent' else ''}"
            f"<{a}, {b}, {c}>" for kind, a, b, c in re.findall(
                r"launch_(bf16|persistent)<(\d+), (\d+), (\d+)>", body)}


def test_every_supported_pair_routes_to_an_instance_the_c_dispatch_has():
    """The bf16 routes of all supported pairs are exactly the instances
    the C dispatch launches: the old flash_bf16 at 64, 128 and 256, and
    flash_bf16_persistent at (96, 64), (112, 112) and (192, 128)."""
    routes = {fa_ops.fwd_route(BF16, Dq, Dv)
              for Dq in range(8, 257, 8) for Dv in range(8, 257, 8)
              if fa_ops.dv_supported(Dq, Dv)}
    assert routes == _c_dispatch_instances()
    assert routes == {"flash_bf16<64, 64, 128>", "flash_bf16<128, 128, 128>",
                      "flash_bf16<256, 256, 64>",
                      "flash_bf16_persistent<96, 64, 192>",
                      "flash_bf16_persistent<112, 112, 128>",
                      "flash_bf16_persistent<192, 128, 96>"}

