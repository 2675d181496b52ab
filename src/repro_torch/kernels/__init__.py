"""Hand-written Hopper kernels. Each kernel package keeps the reference's
three files: ``kernel.py`` (build + launch of the CUDA source in
``repro_torch/csrc``), ``ops.py`` (the wrapper: kernel for CUDA tensors,
plain version for CPU tensors) and ``ref.py`` (the plain PyTorch version).
``_build`` builds and binds every CUDA source. On ``meta`` tensors each
wrapper takes its kernel's shape-only op (``meta``): outputs of the
kernel's shapes, its FLOPs counted, nothing computed."""
from __future__ import annotations


def on_meta(*tensors) -> bool:
    """True when every tensor (None skipped) lies on the ``meta`` device,
    so a wrapper takes its kernel's shape-only op (``kernels.meta``);
    False when the first does not (``on_cpu`` then picks the route). A
    meta tensor beside a real one raises."""
    if not tensors[0].is_meta:
        return False
    devs = [t.device for t in tensors if t is not None]
    if any(d.type != "meta" for d in devs):
        raise ValueError(f"a kernel's meta route needs every tensor on "
                         f"meta, got {devs}")
    return True


def on_cpu(*tensors) -> bool:
    """True when every tensor (None skipped) lies on the CPU, so a wrapper
    runs its plain version; False when all lie on one CUDA device, so it
    launches its kernel. Anything else raises."""
    first = tensors[0]
    index = first.get_device()             # -1 off CUDA
    if index >= 0 and first.is_cuda:       # the kernel's common case, one
        for t in tensors[1:]:              # CUDA device: no set built
            if t is not None and t.get_device() != index:
                break
        else:
            return False
    devs = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"a kernel needs all tensors on one CUDA device "
                         f"(or all on the CPU), got {devs}")
    return False


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and an input of a kernel that has no
    backward requires grad: its output, written through ctypes, would
    carry no ``grad_fn``, and the gradient would be lost without a word.
    Called on the CUDA path only; the plain versions differentiate."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; call it under "
            f"torch.no_grad() or with inputs that do not require grad")


BF16_RTOL = 2.0 ** -7     # one bf16 ulp of the value, at most


def bf16_excess(out, plain, row_rtol: float, scale=None) -> float:
    """The largest |out - plain| over its limit, for bf16 outputs of an
    attention kernel and its plain version. The limit is 2^-7 |plain|
    (both round an f32 result to bf16, so they may differ by one ulp) plus
    ``row_rtol`` times the root mean square of plain's row (the last dim):
    the sums' own error, which scales with the row's size, so a late query
    row of a long causal prefill, whose output is small, is held as
    tightly as an early one. ``scale`` (plain's shape) replaces plain in
    the row's rms where the sums cancel (the attention backward:
    ``attention_bwd_rss``). At most 1 passes; a difference in a row
    whose limit is all 0 gives inf."""
    import torch
    out, plain = out.float(), plain.float()
    scale = plain if scale is None else scale.float()
    lim = BF16_RTOL * plain.abs() \
        + row_rtol * scale.pow(2).mean(dim=-1, keepdim=True).sqrt()
    d = (out - plain).abs()
    ratio = torch.where(lim > 0, d / lim,
                        torch.where(d > 0, float("inf"), 0.0))
    return float(ratio.max()) if ratio.numel() else 0.0
