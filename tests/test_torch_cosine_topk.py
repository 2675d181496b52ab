"""Port of the cosine top-k kernels (K1 f32, K2 int8) held against the JAX
package: the port's wrapper on CPU tensors (its plain version) against the
JAX ``ops.cosine_topk``/``cosine_topk_q8`` in interpret mode, early exit
included, and against the JAX ``ref.py`` oracles where early exit is off.

Indices and hit masks must be identical on inputs clear of ties and theta;
sims are allclose at atol 1e-5 (f32 dot products of unit vectors summed in
another order differ by a few ulps). The CUDA kernels themselves are held
against the plain version on the card by ``test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.cosine_topk import ops as jops
from repro.kernels.cosine_topk import ref as jref
from repro_torch.kernels.cosine_topk import ops as tops
from repro_torch.kernels.cosine_topk import ref as tref

# the suite runs in several worker processes on one host: a small intra-op
# pool per process keeps them from oversubscribing the cores
torch.set_num_threads(2)

ATOL = 1e-5
B, N, D = 5, 1100, 48          # 3 logical tiles of 512, the last ragged


def _unit(rng, n, d):
    v = rng.normal(size=(n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _case(seed):
    """Queries whose near-copies sit in tile 0 (sim ~0.98) and exact
    copies in tile 2 (sim 1.0): early exit at theta 0.9 must serve tile 0,
    exact top-k tile 2. The valid mask has holes, never at those rows."""
    rng = np.random.default_rng(seed)
    rows = _unit(rng, N, D)
    valid = rng.random(N) > 0.25
    q = _unit(rng, B, D)
    near = 7 + 11 * np.arange(B)
    far = 1030 + 13 * np.arange(B)
    rows[far] = q
    noisy = q + 0.2 * _unit(rng, B, D)
    rows[near] = noisy / np.linalg.norm(noisy, axis=1, keepdims=True)
    valid[near] = valid[far] = True
    return q, rows, valid


def _jax(fn, q, rows, valid, k, early, theta, margin):
    if fn == "f32":
        out = jops.cosine_topk(jnp.asarray(q), jnp.asarray(rows), k=k,
                               valid=jnp.asarray(valid.astype(np.int32)),
                               theta=theta, early_exit=early,
                               return_hit=True)
    else:
        codes, scales, _ = jops.quantize_rows(rows)
        out = jops.cosine_topk_q8(jnp.asarray(q), jnp.asarray(codes),
                                  jnp.asarray(scales), k=k,
                                  valid=jnp.asarray(valid.astype(np.int32)),
                                  theta=theta, margin=margin,
                                  early_exit=early, return_hit=True)
    return tuple(np.asarray(x) for x in out)


def _torch(fn, q, rows, valid, k, early, theta, margin):
    t = torch.from_numpy
    if fn == "f32":
        out = tops.cosine_topk(t(q), t(rows), k=k, valid=t(valid),
                               theta=theta, early_exit=early,
                               return_hit=True)
    else:
        codes, scales, _ = tops.quantize_rows(rows)
        out = tops.cosine_topk_q8(t(q), t(codes), t(scales), k=k,
                                  valid=t(valid), theta=theta,
                                  margin=margin, early_exit=early,
                                  return_hit=True)
    return tuple(x.numpy() for x in out)


@pytest.mark.parametrize("early", [False, True])
@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("fn", ["f32", "q8"])
def test_plain_kernel_matches_jax(fn, k, early):
    q, rows, valid = _case(k)
    args = (q, rows, valid, k, early, 0.9, 0.01)
    jv, ji, jh = _jax(fn, *args)
    tv, ti, th = _torch(fn, *args)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_allclose(tv, jv, atol=ATOL)
    assert th.all()
    far = 1030 + 13 * np.arange(B)
    if early:        # tile 0 served: the rule really fired
        assert (ti[:, 0] < 512).all()
    else:            # exact: the exact copies in tile 2 win
        np.testing.assert_array_equal(ti[:, 0], far)


@pytest.mark.parametrize("k", [1, 4, 16])
def test_plain_kernel_matches_jax_ref_oracles(k):
    q, rows, valid = _case(100 + k)
    jv, ji = jref.cosine_topk_ref(jnp.asarray(q), jnp.asarray(rows), k=k,
                                  valid=jnp.asarray(valid))
    tv, ti, _ = tref.cosine_topk_ref(torch.from_numpy(q),
                                     torch.from_numpy(rows), k,
                                     torch.from_numpy(valid))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
    codes, scales, _ = tops.quantize_rows(rows)
    jv, ji = jref.cosine_topk_q8_ref(jnp.asarray(q), jnp.asarray(codes),
                                     jnp.asarray(scales), k=k,
                                     valid=jnp.asarray(valid))
    tv, ti, _ = tref.cosine_topk_q8_ref(
        torch.from_numpy(q), torch.from_numpy(codes),
        torch.from_numpy(scales), k, torch.from_numpy(valid))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


@pytest.mark.parametrize("fn", ["f32", "q8"])
def test_empty_batch_and_empty_valid(fn):
    rng = np.random.default_rng(3)
    rows = _unit(rng, 40, 24)
    empty = _torch(fn, np.zeros((0, 24), np.float32), rows,
                   np.ones(40, bool), 3, False, 2.0, 0.0)
    assert [x.shape for x in empty] == [(0, 3), (0, 3), (0,)]
    q = _unit(rng, 4, 24)
    vs, ix, hit = _torch(fn, q, rows, np.zeros(40, bool), 2, True, 0.5, 0.0)
    assert not np.isfinite(vs).any() and (ix == -1).all() and not hit.any()
    vs, ix, _ = _torch(fn, q, rows, np.isin(np.arange(40), [3, 17, 33]), 2,
                       False, 2.0, 0.0)
    assert set(ix.ravel()) <= {3, 17, 33}


def test_quantize_rows_matches_reference():
    rng = np.random.default_rng(4)
    rows = _unit(rng, 17, 48)
    rows[5] = 0.0
    for a, b in zip(tops.quantize_rows(rows, width=128),
                    jops.quantize_rows(rows, width=128)):
        np.testing.assert_array_equal(a, b)


def test_wrapper_rejects_mixed_devices_and_large_k():
    q = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        tops.cosine_topk(q, torch.zeros((4, 8)), k=17)
    with pytest.raises(ValueError):
        tops.cosine_topk(q, torch.zeros((4, 8), device="meta"))
