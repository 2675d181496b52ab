"""Cross-shard merges of the sharded cache plane (port of
``repro/distributed/collectives.py``, DESIGN.md §2, §11).

The reference runs these inside ``shard_map`` and moves candidates with
``all_gather``/``psum``. The port's plane is driven by one process over a
:class:`~repro_torch.launch.mesh.CacheMesh`: the wire is the copy of each
shard's candidates to the mesh's lead device (``devices[0]``), where the
merge runs. Only O(B x S) candidate scalars cross it, plus the winning
rows' answers.

* :func:`sharded_topk` — exact global top-k with the rows split into S
  contiguous blocks: a local top-k per block, then the top-k of the
  gathered (B, S x k) candidates.
* :func:`cross_shard_top1` — the cache lookup's merge: the highest sim
  wins, ties go to the lowest host row (the single-device argmax's order
  over the concatenated host rows), the theta compare is f32, and the
  answer comes from the owner shard's block only.

* :func:`ring_allreduce_schedule` — the training plane's sum over ranks:
  the reference's reduce-scatter + all-gather ring, one hop a copy of
  one chunk to the next rank's device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

INT32_MAX = int(np.iinfo(np.int32).max)


def local_topk(queries: torch.Tensor, centroids: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense local top-k: (B, D) x (N, D) -> ((B, k) sims, (B, k) idx i32),
    ties to the lower index (as ``jax.lax.top_k``)."""
    sims = queries @ centroids.T
    vals, idx = torch.sort(sims, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)


def sharded_topk(queries: torch.Tensor, centroids: torch.Tensor, k: int,
                 mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact global top-k with ``centroids`` (N, D) split over the mesh in
    S contiguous blocks of N / S rows, block ``s`` on ``mesh.devices[s]``.
    Returns ((B, k) sims, (B, k) global rows) on the lead device."""
    S = len(mesh.devices)
    N = centroids.shape[0]
    if N % S:
        raise ValueError("pad centroids to a multiple of the shard count")
    per = N // S
    vals, idx = [], []
    for s, dev in enumerate(mesh.devices):
        v, i = local_topk(queries.to(dev), centroids[s * per:(s + 1) * per]
                          .to(dev), k)
        vals.append(v.to(mesh.lead))
        idx.append(i.to(mesh.lead) + s * per)         # globalize
    vals_f = torch.cat(vals, dim=1)                   # (B, S * k)
    idx_f = torch.cat(idx, dim=1)
    best, pos = torch.sort(vals_f, dim=1, descending=True, stable=True)
    return best[:, :k], idx_f.gather(1, pos[:, :k])


def cross_shard_top1(best: Sequence[torch.Tensor],
                     host_row: Sequence[torch.Tensor],
                     answer: Sequence[torch.Tensor],
                     answer_id: Sequence[torch.Tensor], theta):
    """Merge the shards' top-1 candidates of one lookup.

    ``best[s]``/``host_row[s]`` (B,) are shard ``s``'s best sim and its
    global host row; ``answer[s]`` (pad, A) and ``answer_id[s]`` (pad,)
    are its whole local blocks. The candidates are gathered to shard 0's
    device; the winner is the highest sim, ties to the lowest host row.
    Its answer is read from the owner shard's block (host row ``r`` lives
    on shard ``r % S`` at local row ``r // S``). Returns (hit, best sim,
    winning host row, answer, answer_id) on shard 0's device, the answer
    zero and the id -1 on a miss; ``hit`` compares f32 sims with
    f32(theta). A NaN best sim (a NaN query) is a miss whose row is shard
    0's candidate."""
    S = len(best)
    lead = best[0].device
    bg = torch.stack([b.to(lead) for b in best], dim=1)           # (B, S)
    rg = torch.stack([r.to(lead, torch.int32) for r in host_row], dim=1)
    m = bg.max(dim=1).values
    # shards tied at the max compete on host row; the others drop out. The
    # winner is an index into the gathered rows, never the key itself: a
    # NaN max matches no shard, and the argmin then picks shard 0's
    # candidate (a miss), as the reference's argmin + take_along_axis does
    key = torch.where(bg == m[:, None], rg, torch.full_like(rg, INT32_MAX))
    win = key.argmin(dim=1)
    row_win = rg.gather(1, win[:, None])[:, 0]
    owner, local = row_win % S, (row_win // S).long()
    ans_win = torch.zeros((len(m), answer[0].shape[1]),
                          dtype=answer[0].dtype, device=lead)
    aid_win = torch.zeros_like(row_win)
    for s in range(S):
        mine = owner == s
        at = local.to(answer[s].device)
        ans_win = torch.where(mine[:, None], answer[s][at].to(lead), ans_win)
        aid_win = torch.where(mine, answer_id[s][at].to(lead, torch.int32),
                              aid_win)
    hit = m >= torch.tensor(np.float32(theta), device=lead)
    answer_out = torch.where(hit[:, None], ans_win, torch.zeros_like(ans_win))
    aid_out = torch.where(hit, aid_win, torch.full_like(aid_win, -1))
    return hit, m, row_win, answer_out, aid_out


def _hop(chunk: torch.Tensor, device) -> torch.Tensor:
    """One ring hop: ``chunk`` copied to the next rank's ``device``."""
    return chunk.to(device)


def ring_allreduce_schedule(xs: Sequence[torch.Tensor]) -> list:
    """The sum of ``xs`` (one tensor a rank, rank r's on its own device)
    on every rank, by the reference's ring (``collectives.py:113``): the
    leading dim padded to a multiple of the world size and cut into that
    many chunks; world - 1 reduce-scatter hops, after which rank r holds
    chunk (r + 1) % world fully summed; world - 1 all-gather hops. A hop
    moves one chunk to the next rank's device (``_hop``). Every rank gets
    the same bits: each chunk is summed once, on one rank, in ring order,
    and copied from there. Returns one tensor a rank, on its device."""
    world = len(xs)
    if world == 1:
        return [xs[0]]
    devs = [x.device for x in xs]
    n = xs[0].shape[0]
    pad = (-n) % world
    acc = []
    for x in xs:
        xp = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]) if pad else \
            x.clone()
        acc.append(xp.reshape(world, -1, *x.shape[1:]))
    # reduce-scatter: at hop i rank r adds rank r-1's chunk (r - i - 1)
    for i in range(world - 1):
        recv = [_hop(acc[(r - 1) % world][(r - i - 1) % world], devs[r])
                for r in range(world)]
        for r in range(world):
            idx = (r - i - 1) % world
            acc[r][idx] = acc[r][idx] + recv[r]
    own = [(r + 1) % world for r in range(world)]
    # all-gather in place: at hop i rank r takes rank r-1's chunk
    # (own_r - i - 1); the world - 1 hops overwrite every chunk but its own
    for i in range(world - 1):
        recv = [_hop(acc[(r - 1) % world][(own[r] - i - 1) % world], devs[r])
                for r in range(world)]
        for r in range(world):
            acc[r][(own[r] - i - 1) % world] = recv[r]
    return [a.reshape(-1, *xs[0].shape[1:])[:n] for a in acc]
