"""The port's MoE layer (``repro_torch.models.layers``: ``moe_gating``,
``moe_apply``) held against the reference's jnp MoE on numpy-seeded inputs,
with the reference's parameters carried over.

Tolerances: the gating is an f32 softmax and a division, 1e-6; ``moe_apply``
on the reduced mixtral in f32 sums 64-term and 128-term products in
another order, 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import layers as JL
from repro_torch import weights
from repro_torch.configs.base import get_config
from repro_torch.models import layers as TL

torch.set_num_threads(2)

GATE_ATOL = 1e-6
MOE_ATOL = 1e-5


def _cfgs(**kw):
    base = dict(dtype="float32", **kw)
    return (get_config("mixtral-8x7b").reduced().replace(**base),
            j_get_config("mixtral-8x7b").reduced().replace(**base))


def _params(jcfg, seed: int, bias: float = 0.0):
    """The reference's MoE params (numpy) and the port's, with ``bias``
    times a fixed direction added to the router's expert-0 column."""
    jp = jax.tree.map(np.array,
                      JL.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32))
    jp["router"][:, 0] += bias * _direction(jcfg.d_model)
    return jp, weights.to_torch(jp, "cpu")


def _direction(d: int) -> np.ndarray:
    return np.random.default_rng(99).choice([-1.0, 1.0], d).astype(
        np.float32) / np.sqrt(d)


def _tokens(d: int, shape, seed: int, shift: float = 0.0) -> np.ndarray:
    """(B, L, d) activations, each shifted by ``shift`` along the biased
    router direction (so that expert 0 draws most tokens)."""
    x = np.random.default_rng(seed).normal(size=(*shape, d))
    return (x + shift * np.sqrt(d) * _direction(d)).astype(np.float32)


def test_moe_gating_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(40, 8)).astype(np.float32)
    logits[3] = 0.5                        # every expert tied
    logits[7, [2, 5, 6]] = 9.0             # three tied at the top
    logits[9] = -1.0
    logits[9, [1, 4]] = 2.0                # two tied at the top
    jg, ji, ja = JL.moe_gating(jnp.asarray(logits), 2)
    tg, ti, ta = TL.moe_gating(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy()[[3, 7, 9]],
                                  [[0, 1], [2, 5], [1, 4]])
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=GATE_ATOL)
    np.testing.assert_allclose(float(ta), float(ja), atol=GATE_ATOL)


CASES = {
    "no-drops": (dict(capacity_factor=8.0), 0.0),
    "drops": (dict(capacity_factor=1.0), 3.0),
    "chunked": (dict(moe_chunk_tokens=8), 0.0),
    "shared-expert": (dict(n_shared_experts=1), 0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_reference(case):
    kw, bias = CASES[case]
    cfg, jcfg = _cfgs(**kw)
    jp, tp = _params(jcfg, seed=1, bias=bias)
    x = _tokens(cfg.d_model, (3, 20), seed=2, shift=1.0 if bias else 0.0)
    jy, ja = JL.moe_apply(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(x))
    ty, ta = TL.moe_apply(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=MOE_ATOL)
    np.testing.assert_allclose(float(ta), float(ja), atol=GATE_ATOL)
    _, idx, _ = TL.moe_gating(torch.from_numpy(x).reshape(60, -1)
                              @ tp["router"], cfg.top_k)
    load = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
    C = TL.moe_capacity(cfg, 60)
    if case == "drops":     # the case must really drop assignments
        assert int(load.max()) > C, (load, C)
    elif case == "no-drops":
        assert int(load.max()) <= C, (load, C)


def test_moe_groups_match_the_reference_vmapped_over_rows():
    """``groups=B``: each batch row its own dispatch and capacity, as the
    reference's one-row call vmapped over the rows (its engine's decode);
    with one group the same biased tokens drop assignments and differ."""
    cfg, jcfg = _cfgs(capacity_factor=1.0)
    jp, tp = _params(jcfg, seed=3, bias=3.0)
    x = _tokens(cfg.d_model, (16, 1), seed=4, shift=1.0)
    jpp = jax.tree.map(jnp.asarray, jp)
    jy = jax.vmap(lambda r: JL.moe_apply(jpp, jcfg, r[None])[0][0])(
        jnp.asarray(x))
    ty, _ = TL.moe_apply(tp, cfg, torch.from_numpy(x), groups=16)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=MOE_ATOL)
    one, _ = TL.moe_apply(tp, cfg, torch.from_numpy(x))
    jone, _ = JL.moe_apply(jpp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(one.numpy(), np.asarray(jone), atol=MOE_ATOL)
    assert np.abs(one.numpy() - ty.numpy()).max() > 100 * MOE_ATOL
