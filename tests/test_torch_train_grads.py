"""``launch.steps.chunked_ce_loss`` and its gradients held against
``jax.value_and_grad`` of the reference's, on reduced fp32 configs with
the reference's parameters and the same numpy batch: the dense kind
(qwen3), MoE with its aux loss (mixtral), MLA (minicpm3) and the SSM kind
(rwkv6) here; the hybrid, the encoder-decoder and the VLM in
``test_torch_train_grads_kinds.py``. The reference's gradient tree is
carried into the port's layout by ``weights.convert_lm``.

Tolerances: the loss at 1e-5; each gradient leaf within 1e-4 of that
leaf's largest |gradient| (f32 sums in another order). A leaf whose
gradient is 0 in exact arithmetic, so that both packages give rounding
noise (the key bias of attention: softmax ignores a score shift common to
every key), is one whose reference gradient stays below 1e-6 of the
largest |gradient| of the whole tree; the port's must stay below that
floor too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.steps import chunked_ce_loss as j_ce
from repro_torch import weights
from repro_torch.launch import steps
from repro_torch.training.optimizer import tree_leaves
from test_torch_train_forward import both, ce_grads, make_batch

torch.set_num_threads(2)

GRAD_RTOL = 1e-4
ZERO_FLOOR = 1e-6


def grads_match(arch: str, B: int = 2, L: int = 32, chunk: int = 8) -> None:
    cfg, jcfg, jp, tp = both(arch)
    b = make_batch(cfg, np.random.default_rng(4), B, L, labels=True)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jloss, jaux), jg = jax.value_and_grad(
        lambda p: j_ce(p, jcfg, jb, chunk), has_aux=True)(jp)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tloss, tg = ce_grads(tp, cfg, tb, chunk)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5)
    with torch.no_grad():
        _, taux = steps.chunked_ce_loss(tp, cfg, tb, chunk)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5)
    ref = weights.convert_lm(jax.tree.map(np.asarray, jg), cfg, device="cpu")
    pairs = list(zip(tree_leaves(tg), tree_leaves(ref)))
    assert [p for (p, _), _ in pairs] == [p for _, (p, _) in pairs]
    top = max(float(r.abs().max()) for _, (_, r) in pairs)
    for (path, g), (_, r) in pairs:
        assert g.shape == r.shape and g.dtype == r.dtype, path
        big = float(r.abs().max())
        if big < ZERO_FLOOR * top:
            assert float(g.abs().max()) < ZERO_FLOOR * top, path
            continue
        err = float((g - r).abs().max())
        assert err <= GRAD_RTOL * big, (path, err, big)


@pytest.mark.parametrize("arch", ["qwen3-14b", "mixtral-8x7b",
                                  "minicpm3-4b", "rwkv6-7b"])
def test_chunked_ce_grads_match_jax(arch):
    grads_match(arch)


def test_vlm_text_span_halves_the_chunk():
    """An odd text span: the chunk halves until it divides it (48 - 16 = 32
    text tokens with chunk 24 -> 8), as the reference's loop does."""
    cfg, jcfg, jp, tp = both("paligemma-3b")
    b = make_batch(cfg, np.random.default_rng(5), 1, 48, labels=True)
    jl, _ = j_ce(jp, jcfg, {k: jnp.asarray(v) for k, v in b.items()}, 24)
    with torch.no_grad():
        tl, _ = steps.chunked_ce_loss(
            tp, cfg, {k: torch.from_numpy(v) for k, v in b.items()}, 24)
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-5)
