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


# K1's pass 1: 16 warps a 512-row logical tile, 8 rows a warp step (two
# rows for each group of 8 lanes, at a stride of 4), 128 rows a sweep of
# the CTA, and a query bucket of 1, 2, 4, 8, 16 or 32 over grid.y.

def _f32_same(q, rows, valid, k, early, theta=0.9, ctx=()):
    kern, plain = _run("f32", q, rows, valid, k, early, theta=theta)
    _assert_same(kern, plain, ctx)
    return kern


@pytest.mark.parametrize("d, width", [(100, 100), (200, 256), (700, 768),
                                      (700, 700), (1000, 1024),
                                      (1024, 1024)])
def test_cuda_f32_every_lane_padded_width(d, width):
    """Dp 128, 256, 768 and 1024: queries of dim d against rows stored at
    ``width`` (zero columns on the right, the serving mirror's layout) or
    at d, which the wrapper pads."""
    rng = np.random.default_rng(d + width)
    n, Bq = 1300, 5
    rows = np.zeros((n, width), np.float32)
    rows[:, :d] = _unit(rng, n, d)
    valid = rng.random(n) > 0.2
    q = _unit(rng, Bq, d)
    rows[900 + np.arange(Bq), :d] = q
    valid[900 + np.arange(Bq)] = True
    for k in (1, 16):
        for early in (False, True):
            _f32_same(q, rows, valid, k, early, ctx=(d, width, k, early))


@pytest.mark.parametrize("Bq", [2, 3, 16, 17, 64])
def test_cuda_f32_query_bucket_edges(Bq):
    """The buckets' edges and a batch of two full groups of 32."""
    rng = np.random.default_rng(200 + Bq)
    n, d = 2100, 768
    rows = _unit(rng, n, d)
    valid = rng.random(n) > 0.1
    q = _unit(rng, Bq, d)
    near = 5 + 7 * np.arange(Bq)
    noisy = q + 0.2 * _unit(rng, Bq, d)
    rows[near] = noisy / np.linalg.norm(noisy, axis=1, keepdims=True)
    valid[near] = True
    for k in (1, 16):
        for early in (False, True):
            _f32_same(q, rows, valid, k, early, ctx=(Bq, k, early))


@pytest.mark.parametrize("n", [1, 7, 127, 129, 515, 4099])
def test_cuda_f32_row_counts_ragged_against_the_sweep(n):
    """N not a multiple of a warp step (8), a CTA sweep (128) or a logical
    tile (512), down to one row (block_n 128)."""
    rng = np.random.default_rng(300 + n)
    d, Bq = 768, 4
    rows = _unit(rng, n, d)
    valid = rng.random(n) > 0.1
    q = _unit(rng, Bq, d)
    rows[n - 1] = q[0]
    valid[n - 1] = True
    for k in (1, 16):
        kern = _f32_same(q, rows, valid, k, False, ctx=(n, k))
        assert kern[1][0, 0].item() == n - 1


def test_cuda_f32_invalid_runs_at_group_sweep_and_tile_edges():
    """Invalid runs across a row group's two rows, a CTA sweep's edge, a
    logical tile's edge and one whole tile; every row of a tile invalid
    but one; best rows planted right beside each run."""
    rng = np.random.default_rng(11)
    n, d, Bq = 3000, 768, 4
    rows = _unit(rng, n, d)
    valid = np.ones(n, bool)
    valid[0:4] = False                   # row a of every group of a step
    valid[124:132] = False               # across the first sweep's edge
    valid[505:519] = False               # across tile 0's edge
    valid[1024:1536] = False             # tile 2
    valid[1536:2048] = False
    valid[2047] = True                   # tile 3 holds one valid row
    q = _unit(rng, Bq, d)
    plant = [4, 132, 519, 2047]
    rows[plant] = q
    rows[[3, 131, 518, 1100]] = q        # the same rows, but invalid
    for k in (1, 16):
        for early in (False, True):
            kern = _f32_same(q, rows, valid, k, early, ctx=(k, early))
            if not early:
                np.testing.assert_array_equal(kern[1][:, 0].cpu().numpy(),
                                              plant)


def test_cuda_f32_ties_across_groups_sweeps_and_tiles():
    """One query's exact copy at rows that different lanes, row groups,
    warps, sweeps and tiles score: the lowest row wins, and k = 16 lists
    them in row order."""
    rng = np.random.default_rng(12)
    n, d = 2000, 768
    rows = _unit(rng, n, d)
    valid = np.ones(n, bool)
    q = _unit(rng, 3, d)
    ties = [1700, 600, 511, 300, 130, 13, 9]    # 9 and 13: rows a and b
    rows[ties] = q[0]
    rows[[255, 128, 127]] = q[1]
    rows[[8, 12]] = q[2]
    for k in (1, 16):
        kern = _f32_same(q, rows, valid, k, False, ctx=(k,))
        ki = kern[1].cpu().numpy()
        assert list(ki[:, 0]) == [9, 127, 8]
        if k == 16:
            assert list(ki[0, :7]) == sorted(ties)
            assert list(ki[1, :3]) == [127, 128, 255]


@pytest.mark.parametrize("stop", ["tile0", "middle", "never"])
def test_cuda_f32_k16_early_exit_stop_tile_at_served_width(stop):
    """k = 16 at dim 768 with a batch of 17 (bucket 32): early exit stops
    after tile 0, after tile 4 of 8, or never."""
    rng = np.random.default_rng(13)
    n, d, Bq = 4000, 768, 17
    rows = _unit(rng, n, d)
    valid = rng.random(n) > 0.05
    q = _unit(rng, Bq, d)
    tile_of = np.zeros(Bq, int)
    if stop == "middle":
        tile_of = np.arange(Bq) % 5
    near = 512 * tile_of + 20 + 3 * np.arange(Bq)
    noisy = q + 0.2 * _unit(rng, Bq, d)
    rows[near] = noisy / np.linalg.norm(noisy, axis=1, keepdims=True)
    valid[near] = True
    far = 3600 + np.arange(Bq)
    rows[far] = q
    valid[far] = True
    kern = _f32_same(q, rows, valid, 16, True,
                     theta=2.0 if stop == "never" else 0.9, ctx=(stop,))
    served = kern[1][:, 0].cpu().numpy()
    if stop == "never":
        np.testing.assert_array_equal(served, far)
    else:
        np.testing.assert_array_equal(served, near)
        assert (kern[1].cpu().numpy() < 512 * (tile_of.max() + 1)).all()


def test_cuda_f32_two_calls_bit_identical_and_outputs_fresh():
    """Two calls give the same bits; the second does not write over the
    first's outputs (the candidate scratch is reused, the outputs are
    not)."""
    rng = np.random.default_rng(14)
    n, d, Bq = 3000, 768, 8
    q = torch.from_numpy(_unit(rng, Bq, d)).to(DEV)
    rows = torch.from_numpy(_unit(rng, n, d)).to(DEV)
    valid = torch.from_numpy(rng.random(n) > 0.1).to(DEV)
    a = ops.cosine_topk(q, rows, k=16, valid=valid, theta=0.5,
                        early_exit=True, return_hit=True)
    snap = [x.clone() for x in a]
    b = ops.cosine_topk(q, rows, k=16, valid=valid, theta=0.5,
                        early_exit=True, return_hit=True)
    c = ops.cosine_topk(q[:3], rows, k=4, valid=valid, return_hit=True)
    torch.cuda.synchronize()
    for x, y, s in zip(a, b, snap):
        assert torch.equal(x, s) and torch.equal(x, y)
    assert a[0].data_ptr() != b[0].data_ptr() != c[0].data_ptr()
    _assert_same(c, ref.cosine_topk_ref(q[:3], rows, 4, valid), "k=4")


# K1's shard-local mode (cosine_top1_local) and the sharded cache plane on
# virtual shards of one card.

@pytest.mark.parametrize("Bq, n, d", [(4, 32, 768), (4, 33, 768),
                                      (5, 600, 48), (1, 16384, 768),
                                      (32, 4099, 100)])
def test_cuda_top1_local_matches_plain_version(Bq, n, d):
    """Blocks shorter than one 512-row tile and longer; an all-invalid
    block reports -inf at row 0; each call counts one K1-local launch and
    none of K1's."""
    rng = np.random.default_rng(n)
    rows = _unit(rng, n, d)
    q = _unit(rng, Bq, d)
    q[0] = rows[n - 1]
    r, qq = torch.from_numpy(rows).to(DEV), torch.from_numpy(q).to(DEV)
    for valid in (rng.random(n) > 0.3, np.zeros(n, bool)):
        valid[n - 1] = valid.any()
        v = torch.from_numpy(valid).to(DEV)
        k1, local = ops.cosine_topk.launches, ops.cosine_top1_local.launches
        kb, kl = ops.cosine_top1_local(qq, r, v)
        pb, pl = ref.cosine_top1_local_ref(qq, r, v)
        torch.cuda.synchronize()
        assert ops.cosine_topk.launches == k1
        assert ops.cosine_top1_local.launches == local + 1
        assert kl.dtype == torch.int32 and torch.equal(kl, pl)
        assert torch.equal(torch.isfinite(kb), torch.isfinite(pb))
        fin = torch.isfinite(pb)
        torch.testing.assert_close(kb[fin], pb[fin], atol=ATOL, rtol=0)
        if not valid.any():
            assert not fin.any() and (kl == 0).all()
        else:
            assert kl[0].item() == n - 1


def test_cuda_top1_local_sims_do_not_depend_on_block_or_tile():
    """K1's per-row arithmetic does not depend on N or on the row's tile:
    each shard block's best sim equals K1's over the whole plane with only
    that shard's rows valid, bit for bit. This is why sharded ``pallas``
    sims equal unsharded ones."""
    rng = np.random.default_rng(21)
    n, d, S, Bq = 3000, 768, 4, 4
    rows = _unit(rng, n, d)
    q = torch.from_numpy(_unit(rng, Bq, d)).to(DEV)
    r = torch.from_numpy(rows).to(DEV)
    for s in range(S):
        block = r[s::S].contiguous()
        kb, kl = ops.cosine_top1_local(q, block)
        only = torch.zeros(n, dtype=torch.bool, device=DEV)
        only[s::S] = True
        fv, fi = ops.cosine_topk(q, r, k=1, valid=only)
        assert torch.equal(kb, fv[:, 0]), s
        assert torch.equal(kl.long() * S + s, fi[:, 0].long()), s


@pytest.mark.parametrize("S", [2, 4, 8])
def test_cuda_sharded_plane_decides_as_single_device(S):
    """The sharded plane on S virtual shards of the card: pallas (K1's
    shard-local mode) equals the unsharded pallas cache field for field,
    sims bit for bit; dense decides as dense, sims within ATOL; pallas_q8
    decides as dense with bit-equal sims (DESIGN.md §15)."""
    from repro_torch.core.semantic_cache import SemanticCache
    from repro_torch.core.store import CentroidStore
    from repro_torch.distributed.cache_plane import ShardedCacheConfig
    from repro_torch.launch.mesh import make_cache_mesh
    A = 16

    def stream(backend, shards):
        rng = np.random.default_rng(S)
        shard = ShardedCacheConfig(n_shards=shards, mesh=make_cache_mesh(
            shards, devices=[DEV] * shards)) if shards > 1 else None
        cache = SemanticCache(D, A, capacity=760, backend=backend,
                              device=DEV, shard=shard)
        pool = _unit(rng, 700, D)
        st = CentroidStore(D, A)
        st.add(pool, pool[:, :A], rng.uniform(1, 50, 700).round(),
               answer_id=np.arange(700))
        cache.set_centroids(st)
        out = []
        for step in range(10):
            m = int(rng.integers(1, 12))
            q = _unit(rng, m, D)
            q[::2] = pool[rng.integers(0, len(pool), size=m)][::2]
            out.append(cache.lookup(q, 0.9))
            for _ in range(int(rng.integers(0, 9))):
                v = _unit(rng, 1, D)[0]
                cache.insert_spill(v, v[:A], answer_id=1000 + step)
                pool = np.vstack([pool, v])
        return out, cache

    dense, _ = stream("dense", 1)
    for backend in ("pallas", "dense", "pallas_q8"):
        single, _ = stream(backend, 1)
        sharded, cache = stream(backend, S)
        assert cache.dev_row_writes > 0 and cache.dev_rebuilds == 1
        for r, u, d in zip(sharded, single, dense):
            for f in ("hit", "entry", "region", "answer_id", "answer"):
                np.testing.assert_array_equal(getattr(r, f), getattr(u, f))
            if backend == "dense":
                np.testing.assert_allclose(r.sim, u.sim, atol=ATOL, rtol=0)
            else:
                np.testing.assert_array_equal(r.sim, (u if backend ==
                                                      "pallas" else d).sim)
