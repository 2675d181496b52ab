"""The port's training forward held against the JAX package: ``lm.forward``
logits and MoE aux loss for every LM config (reduced, fp32, the
reference's parameters carried over by ``repro_torch.weights``, the same
numpy batch), ``lm.forward`` with remat against without, the bf16
gradient barrier bit for bit against the reference's custom VJP, and the
model registry.

Tolerances: logits of the reduced models (|logit| < ~1 at init scale
0.02) at atol 1e-4, the suite's LOGIT_ATOL (fp32 matmuls summed in
another order drift by a few ulps a layer); the aux loss, a mean of
products of softmax probabilities and counts, at 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS, get_config as j_get_config
from repro.models import layers as JL, lm as JLM
from repro_torch import weights
from repro_torch.configs.base import get_config
from repro_torch.launch import steps
from repro_torch.models import layers as TL, lm as TLM, registry
from repro_torch.training.optimizer import tree_leaves

torch.set_num_threads(2)

CPU = "cpu"
LOGIT_ATOL = 1e-4


def make_batch(cfg, rng, B: int = 2, L: int = 32, labels: bool = False
               ) -> dict:
    """The reference tests' batch (``tests/test_models.py::make_batch``) as
    numpy arrays, fed to both packages."""
    b = {}
    if cfg.family == "vlm":
        b["tokens"] = rng.integers(0, cfg.vocab_size,
                                   (B, L - cfg.prefix_len)).astype(np.int32)
        b["patch_embed"] = rng.normal(
            size=(B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
        if cfg.is_encoder_decoder:
            b["frames"] = rng.normal(
                size=(B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    if labels:
        b["labels"] = rng.integers(0, cfg.vocab_size,
                                   b["tokens"].shape).astype(np.int32)
    return b


def ce_grads(params, cfg, batch: dict, chunk: int):
    """(chunked CE loss, its gradient tree) through ``steps.value_and_grad``."""
    return steps.value_and_grad(
        lambda p: steps.chunked_ce_loss(p, cfg, batch, chunk)[0], params)


def both(arch: str, seed: int = 0, **replace):
    """(port cfg, reference cfg, reference params, port params), reduced
    and fp32."""
    cfg = get_config(arch).reduced().replace(dtype="float32", **replace)
    jcfg = j_get_config(arch).reduced().replace(dtype="float32", **replace)
    jp = JLM.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = weights.convert_lm(jax.tree.map(np.asarray, jp), cfg, device=CPU)
    return cfg, jcfg, jp, tp


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_logits_and_aux_match_jax(arch):
    cfg, jcfg, jp, tp = both(arch)
    b = make_batch(cfg, np.random.default_rng(1))
    jl, ja = JLM.forward(jp, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        tl, ta = TLM.forward(tp, cfg, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-5)
    if cfg.is_moe:
        assert float(ta) > 0


@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-7b", "zamba2-7b",
                                  "whisper-base"])
def test_remat_gives_the_same_forward_and_grads(arch):
    """``cfg.remat`` recomputes each layer in the backward
    (torch.utils.checkpoint): the same loss and gradients, bit for bit, as
    without it."""
    cfg, _, _, tp = both(arch)
    b = {k: torch.from_numpy(v) for k, v in
         make_batch(cfg, np.random.default_rng(2), 2, 16, True).items()}
    l0, g0 = ce_grads(tp, cfg, b, 8)
    l1, g1 = ce_grads(tp, cfg.replace(remat=True), b, 8)
    assert torch.equal(l0, l1)
    for (path, x), (_, y) in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(x, y), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_grad_barrier_bit_for_bit(dtype):
    """Identity forward; the cotangent rounded through bf16, bit for bit as
    the reference's custom VJP."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 33)).astype(np.float32)
    ct = (rng.normal(size=(4, 33)) * np.exp(rng.normal(size=(4, 33)) * 4)
          ).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jx, jct = jnp.asarray(x, jdt), jnp.asarray(ct, jdt)
    jy, vjp = jax.vjp(JL.bf16_grad_barrier, jx)
    jg = np.asarray(vjp(jct)[0].astype(jnp.float32))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ty = TL.bf16_grad_barrier(tx)
    (tg,) = torch.autograd.grad(ty, tx, torch.from_numpy(ct).to(tdt))
    assert torch.equal(ty.detach(), tx.detach())
    np.testing.assert_array_equal(tg.float().numpy(), jg)
    if dtype == "float32":
        assert not np.array_equal(jg, ct)      # the rounding happened


def test_dp_constrain_is_the_barrier_when_the_boundary_is_on():
    x = torch.randn(2, 3, dtype=torch.bfloat16, requires_grad=True)
    ct = torch.randn(2, 3, dtype=torch.bfloat16)
    try:
        TL.set_bf16_boundary(True)
        y = TL.dp_constrain(x, ("data",))
        assert "BF16GradBarrier" in type(y.grad_fn).__name__
        xf = x.detach().float()
        assert TL.dp_constrain(xf, ("data",)) is xf     # bf16 only
    finally:
        TL.set_bf16_boundary(False)
    assert TL.dp_constrain(x, ("data",)) is x
    (g,) = torch.autograd.grad(y, x, ct)
    assert torch.equal(g, ct)


def test_registry_builds_every_family():
    for name in ("qwen3-14b", "siso-embedder"):
        cfg, init, fwd = registry.build(name, reduced=True)
        jcfg = j_get_config(name).reduced()
        assert cfg.__dict__ == jcfg.__dict__
        gen = torch.Generator().manual_seed(0)
        p = registry.init_params(gen, cfg, CPU)
        assert set(p) == set(init(torch.Generator().manual_seed(0), cfg,
                                  CPU))
        assert fwd is (TLM.forward if name == "qwen3-14b"
                       else registry.embedder.encode)
