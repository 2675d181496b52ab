"""The hand-written CUDA kernels (K1 f32, K2 int8) on the card, held against
their plain PyTorch versions; the three cache backends on the card, held
against each other. The kernels have no CPU mode, so these tests are marked
``gpu`` and skip without a CUDA device. The file imports neither jax nor the
reference package, so it also runs on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_kernels.py

Indices and hit masks must be identical on inputs clear of ties and theta;
sims are allclose at atol 1e-5 (f32 dot products of unit vectors summed in
another order differ by a few ulps).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.cosine_topk import ops, ref

pytestmark = pytest.mark.gpu

ATOL = 1e-5
B, N, D = 5, 1100, 48          # 3 logical tiles of 512, the last ragged
DEV = "cuda"


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")


def _unit(rng, n, d):
    v = rng.normal(size=(n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _case(seed):
    """Near copies of the queries in tile 0 (sim ~0.98), exact copies in
    tile 2 (sim 1.0), holes in the valid mask elsewhere."""
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


def _both(fn, q, rows, valid, k, early):
    """(kernel result, plain result) on the card."""
    q, v = torch.from_numpy(q).to(DEV), torch.from_numpy(valid).to(DEV)
    if fn == "f32":
        r = torch.from_numpy(rows).to(DEV)
        kern = ops.cosine_topk(q, r, k=k, valid=v, theta=0.9,
                               early_exit=early, return_hit=True)
        plain = ref.cosine_topk_ref(q, r, k, v, 0.9, early)
    else:
        codes, scales, _ = ops.quantize_rows(rows)
        c = torch.from_numpy(codes).to(DEV)
        s = torch.from_numpy(scales).to(DEV)
        kern = ops.cosine_topk_q8(q, c, s, k=k, valid=v, theta=0.9,
                                  margin=0.01, early_exit=early,
                                  return_hit=True)
        plain = ref.cosine_topk_q8_ref(q, c, s, k, v, 0.9, 0.01, early)
    torch.cuda.synchronize()
    return kern, plain


@pytest.mark.parametrize("fn", ["f32", "q8"])
def test_cuda_kernel_matches_plain_version(fn):
    for k, early in ((1, True), (1, False), (16, False), (16, True)):
        (kv, ki, kh), (pv, pi, ph) = _both(fn, *_case(7 + k), k, early)
        assert torch.equal(ki, pi) and torch.equal(kh, ph), (k, early)
        torch.testing.assert_close(kv, pv, atol=ATOL, rtol=0)
        served = ki[:, 0].cpu().numpy()
        if early:
            assert (served < 512).all()
        else:
            np.testing.assert_array_equal(served, 1030 + 13 * np.arange(B))


@pytest.mark.parametrize("fn", ["f32", "q8"])
def test_cuda_kernel_counts_launches_and_handles_empty_inputs(fn):
    wrapper = ops.cosine_topk if fn == "f32" else ops.cosine_topk_q8
    q, rows, valid = _case(3)
    before = wrapper.launches
    _both(fn, q, rows, valid, 4, False)
    assert wrapper.launches == before + 1
    (kv, ki, kh), _ = _both(fn, q[:0], rows, valid, 4, False)
    assert kv.shape == (0, 4) and ki.shape == (0, 4) and kh.shape == (0,)
    (kv, ki, kh), _ = _both(fn, q, rows, np.zeros(N, bool), 2, True)
    assert not torch.isfinite(kv).any() and (ki == -1).all()
    assert not kh.any()



def _run(fn, q, rows, valid, k, early, theta=0.9, margin=0.01):
    """Kernel and plain results for numpy inputs, and the thresholds."""
    q, v = torch.from_numpy(q).to(DEV), torch.from_numpy(valid).to(DEV)
    if fn == "f32":
        r = torch.from_numpy(rows).to(DEV)
        kern = ops.cosine_topk(q, r, k=k, valid=v, theta=theta,
                               early_exit=early, return_hit=True)
        plain = ref.cosine_topk_ref(q, r, k, v, theta, early)
    else:
        codes, scales, _ = ops.quantize_rows(rows)
        c = torch.from_numpy(codes).to(DEV)
        s = torch.from_numpy(scales).to(DEV)
        kern = ops.cosine_topk_q8(q, c, s, k=k, valid=v, theta=theta,
                                  margin=margin, early_exit=early,
                                  return_hit=True)
        plain = ref.cosine_topk_q8_ref(q, c, s, k, v, theta, margin, early)
    torch.cuda.synchronize()
    return kern, plain


def _assert_same(kern, plain, ctx):
    (kv, ki, kh), (pv, pi, ph) = kern, plain
    assert torch.equal(ki, pi) and torch.equal(kh, ph), ctx
    torch.testing.assert_close(kv, pv, atol=ATOL, rtol=0)


@pytest.mark.parametrize("Bq", [1, 4, 5, 8, 32, 33])
@pytest.mark.parametrize("fn", ["f32", "q8"])
def test_cuda_kernel_every_query_bucket(fn, Bq):
    """Every query bucket of K2's pass 1 (1, 2, 4, 8, 16, 32 and a second
    group past 32) and its ragged edge, at the served width (768) over a
    row count that is not a multiple of 512 (6 logical tiles, the last of
    440 rows), k in {1, 16}, early exit on and off."""
    rng = np.random.default_rng(100 + Bq)
    n, d = 3000, 768
    rows = _unit(rng, n, d)
    valid = rng.random(n) > 0.1
    q = _unit(rng, Bq, d)
    near = 5 + 7 * np.arange(Bq)                  # tile 0, sim ~0.98
    noisy = q + 0.2 * _unit(rng, Bq, d)
    rows[near] = noisy / np.linalg.norm(noisy, axis=1, keepdims=True)
    valid[near] = True
    for k in (1, 16):
        for early in (False, True):
            _assert_same(*_run(fn, q, rows, valid, k, early),
                         (fn, Bq, k, early))


@pytest.mark.parametrize("fn", ["f32", "q8"])
def test_cuda_kernel_ties_go_to_the_lower_row(fn):
    """Equal sims in two logical tiles (and twice in one) rank by row."""
    rng = np.random.default_rng(5)
    rows = _unit(rng, N, D)
    valid = np.ones(N, bool)
    q = _unit(rng, 2, D)
    rows[[100, 1000, 1001]] = q[0]
    rows[[40, 600]] = q[1]
    for k in (1, 16):
        kern, plain = _run(fn, q, rows, valid, k, False)
        _assert_same(kern, plain, (fn, k))
        ki = kern[1].cpu().numpy()
        assert ki[0, 0] == 100 and ki[1, 0] == 40
        if k == 16:
            assert list(ki[0, :3]) == [100, 1000, 1001]
            assert list(ki[1, :2]) == [40, 600]


@pytest.mark.parametrize("stop", ["tile0", "middle", "never"])
@pytest.mark.parametrize("fn", ["f32", "q8"])
def test_cuda_kernel_early_exit_stop_tile(fn, stop):
    """Early exit stops after tile 0, after tile 3 of 6 (the last query to
    clear theta does so there), or never; exact copies in the last tile
    are served only when it is reached."""
    rng = np.random.default_rng(9)
    n, d, Bq = 3000, 96, 4
    rows = _unit(rng, n, d)
    valid = np.ones(n, bool)
    q = _unit(rng, Bq, d)
    tile_of = {"tile0": [0, 0, 0, 0], "middle": [1, 1, 0, 3],
               "never": [0, 0, 0, 0]}[stop]
    near = np.array([512 * t + 11 + 3 * i for i, t in enumerate(tile_of)])
    noisy = q + 0.2 * _unit(rng, Bq, d)
    rows[near] = noisy / np.linalg.norm(noisy, axis=1, keepdims=True)
    rows[2600 + np.arange(Bq)] = q                 # last tile, sim 1.0
    theta = 2.0 if stop == "never" else 0.9
    for k in (1, 16):
        kern, plain = _run(fn, q, rows, valid, k, True, theta=theta)
        _assert_same(kern, plain, (fn, stop, k))
        served = kern[1][:, 0].cpu().numpy()
        if stop == "never":
            np.testing.assert_array_equal(served, 2600 + np.arange(Bq))
        else:
            np.testing.assert_array_equal(served, near)
            last = max(tile_of)
            assert (kern[1].cpu().numpy() < 512 * (last + 1)).all()


def test_cuda_cache_backends_decide_identically():
    """One interleaved lookup / insert_spill stream with a shadow commit:
    pallas (K1) and pallas_q8 (K2 + rescore) give the dense backend's
    decisions; q8 sims equal dense sims bit for bit (DESIGN.md §15)."""
    from repro_torch.core.semantic_cache import SemanticCache
    from repro_torch.core.store import CentroidStore
    A = 16

    def store(vecs, sizes, aid0):
        st = CentroidStore(D, A)
        st.add(vecs, vecs[:, :A], sizes,
               answer_id=np.arange(len(vecs)) + aid0)
        return st

    def stream(backend):
        rng = np.random.default_rng(0)
        cache = SemanticCache(D, A, capacity=760, backend=backend,
                              device=DEV)
        pool = _unit(rng, 700, D)
        cache.set_centroids(store(pool, rng.uniform(1, 50, 700).round(), 0))
        out = []
        for step in range(12):
            n = int(rng.integers(1, 12))
            pick = rng.integers(0, len(pool), size=n)
            q = _unit(rng, n, D)
            q[::2] = pool[pick][::2]
            theta = float(rng.choice([0.6, 0.95, -1.0]))
            out.append(cache.lookup(q, theta, update_counts=theta > 0))
            for _ in range(int(rng.integers(0, 9))):
                v = _unit(rng, 1, D)[0]
                cache.insert_spill(v, v[:A], answer_id=1000 + step)
                pool = np.vstack([pool, v])
            if step == 5:
                st = store(_unit(rng, 300, D), np.arange(300, 0, -1.0), 5000)
                cache.begin_shadow(len(st))
                cache.shadow_write(st.vectors, st.answers, st.answer_id)
                cache.commit_shadow(st)
                pool = np.vstack([pool, st.vectors])
        return out

    dense = stream("dense")
    assert sum(r.hit.sum() for r in dense) > 10
    for backend in ("pallas", "pallas_q8"):
        for r, d in zip(stream(backend), dense):
            for f in ("hit", "entry", "region", "answer_id", "generation"):
                np.testing.assert_array_equal(getattr(r, f), getattr(d, f))
            if backend == "pallas_q8":
                np.testing.assert_array_equal(r.sim, d.sim)
            else:
                np.testing.assert_allclose(r.sim, d.sim, atol=ATOL, rtol=0)
