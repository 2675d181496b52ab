"""The WKV6 backward on the CPU: ``wkv6_bwd_ref`` (the plain version of the
K5-bwd kernel, the reverse recurrence as a step loop) against autograd of
the plain forward ``wkv6_ref`` and against ``jax.grad`` of the
reference's ``rwkv6_linear_attention`` (``repro/models/ssm.py:93``, its
chunked step scan padded with w = 1, k = 0 steps), and ``WKV6Fn`` (the
route ``kernels.wkv6.ops.wkv6`` takes under grad) giving those gradients
on CPU tensors. Cases: L = 1, 17 and 33 (the reference's chunk 16 pads 17
and 33), a nonzero initial state, a cotangent of the final state, K = V
of 4 and 16. The checkpoints that K5 writes for K5-bwd: their plain
version ``wkv6_ckpt_ref`` (the state at the start of every 16-step chunk)
against the reference's final state on each 16 c-step prefix, at K 16, 17
and 64 and L 1, 17 and 50 with a carried state; ``wkv6_bwd`` given them and
given none (it recomputes them), and through ``WKV6Fn``, which saves
them, the same bits; checkpoints of other inputs move its gradients.

Inputs are made from a numpy seed in f32; w is the reference's decay
exp(-exp(x)) over x in [-3, 1]. Tolerance: each gradient within 1e-5 of
its largest |gradient| (f32 sums in another order); a checkpoint within
1e-6 of the largest |state| (f32 updates in another order, one product
and sum a step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import rwkv6_linear_attention as j_wkv
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.kernels.wkv6 import ref as wkv6_ref

torch.set_num_threads(2)

RTOL = 1e-5
CHUNK = 16
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")

# (B, L, H, K, initial state, final-state cotangent)
CASES = {
    "L1": (2, 1, 3, 4, False, False),
    "L17": (2, 17, 3, 4, False, False),
    "L33": (1, 33, 2, 16, False, False),
    "state": (2, 17, 2, 8, True, False),
    "final_cotangent": (2, 33, 2, 8, False, True),
    "both": (1, 20, 2, 16, True, True),
}


def _inputs(B, L, H, K, carried, cotangent, seed):
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.normal(size=(B, L, H, K)).astype(np.float32)
                   for _ in range(4))
    w = np.exp(-np.exp(rng.uniform(-3.0, 1.0, size=(B, L, H, K)))
               ).astype(np.float32)
    u = rng.normal(size=(H, K)).astype(np.float32)
    s = (rng.normal(size=(B, H, K, K)) if carried
         else np.zeros((B, H, K, K))).astype(np.float32)
    ds = rng.normal(size=(B, H, K, K)).astype(np.float32) if cotangent \
        else None
    return (r, k, v, w, u, s), dy, ds


def _close(got, want, what):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= RTOL * np.abs(want).max(), (what, err, np.abs(want).max())


def _jax_grads(xs, dy, ds):
    def loss(*xs):
        y, S = j_wkv(*xs, CHUNK)
        out = jnp.sum(y * dy)
        return out if ds is None else out + jnp.sum(S * ds)
    return jax.grad(loss, argnums=tuple(range(6)))(*xs)


@pytest.mark.parametrize("case", list(CASES))
def test_wkv6_bwd_ref_matches_autograd_and_jax(case):
    B, L, H, K, carried, cot = CASES[case]
    xs, dy, ds = _inputs(B, L, H, K, carried, cot, seed=L + K)
    tx = [torch.from_numpy(x) for x in xs]
    tdy = torch.from_numpy(dy)
    tds = None if ds is None else torch.from_numpy(ds)
    got = wkv6_ref.wkv6_bwd_ref(*tx, tdy, tds)
    leaves = [x.clone().requires_grad_() for x in tx]
    y, S = wkv6_ref.wkv6_ref(*leaves)
    loss = (y * tdy).sum() + (0 if tds is None else (S * tds).sum())
    # w reaches the loss only through the final state (not at L = 1
    # without its cotangent): autograd gives None there, zeros in effect
    auto = [torch.zeros_like(x) if g is None else g for x, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    jg = _jax_grads(xs, dy, ds)
    for name, a, b, c in zip(NAMES, got, auto, jg):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        _close(a.numpy(), b.numpy(), name)
        _close(a.numpy(), c, name)


@pytest.mark.parametrize("case", list(CASES))
def test_wkv6_fn_gives_the_gradients_on_the_cpu(case):
    B, L, H, K, carried, cot = CASES[case]
    xs, dy, ds = _inputs(B, L, H, K, carried, cot, seed=3 * L + K)
    leaves = [torch.from_numpy(x).requires_grad_() for x in xs]
    calls = wkv6_ops.wkv6.launches_bwd
    y, S = wkv6_ops.wkv6(*leaves)
    assert type(y.grad_fn).__name__ == "WKV6FnBackward"
    outs, cots = [y], [torch.from_numpy(dy)]
    if ds is not None:
        outs.append(S)
        cots.append(torch.from_numpy(ds))
    got = torch.autograd.grad(outs, leaves, cots)
    assert wkv6_ops.wkv6.launches_bwd == calls     # no kernel on the CPU
    for name, a, c in zip(NAMES, got, _jax_grads(xs, dy, ds)):
        _close(a.numpy(), c, name)


def test_wkv6_bwd_ref_keeps_each_input_dtype():
    """bf16 r, k, v and u give bf16 gradients, computed in f32 and rounded
    once; w and the state stay f32."""
    xs, dy, _ = _inputs(1, 9, 2, 4, True, False, seed=5)
    tx = [torch.from_numpy(x) for x in xs]
    for i in (0, 1, 2, 4):
        tx[i] = tx[i].to(torch.bfloat16)
    got = wkv6_ref.wkv6_bwd_ref(*tx, torch.from_numpy(dy))
    assert [g.dtype for g in got] == [x.dtype for x in tx]
    want = wkv6_ref.wkv6_bwd_ref(*(x.float() for x in tx),
                                 torch.from_numpy(dy))
    for a, b in zip(got, want):
        assert torch.equal(a, b.to(a.dtype))


CKPT_RTOL = 1e-6


@pytest.mark.parametrize("K", [16, 17, 64])
@pytest.mark.parametrize("L", [1, 17, 50])
def test_wkv6_ckpt_ref_matches_the_reference_prefix_states(L, K):
    """Chunk c's checkpoint is the reference's final state after the first
    16 c steps (chunk 0's the state carried in), transposed."""
    xs, _, _ = _inputs(2, L, 2, K, True, False, seed=7 * L + K)
    r, k, v, w, u, s = xs
    got = wkv6_ref.wkv6_ckpt_ref(*(torch.from_numpy(x) for x in (k, v, w, s)))
    nc = -(-L // CHUNK)
    assert got.shape == (2, 2, nc, K, K) and got.dtype == torch.float32
    for c in range(nc):
        t = c * CHUNK
        want = s if t == 0 else np.asarray(j_wkv(
            r[:, :t], k[:, :t], v[:, :t], w[:, :t], u, s, CHUNK)[1])
        # K5's layout: each state transposed
        err = np.abs(got[:, :, c].transpose(-1, -2).numpy() - want).max()
        assert err <= CKPT_RTOL * np.abs(want).max(), (c, err)


@pytest.mark.parametrize("case", list(CASES))
def test_wkv6_bwd_from_checkpoints_gives_the_same_bits(case):
    """``wkv6_bwd`` on CPU tensors given ``wkv6_ckpt_ref``'s checkpoints
    and given none, and autograd through ``WKV6Fn`` (which saves them),
    agree bit for bit; checkpoints of other inputs change the gradients
    (the backward restarts its states there)."""
    B, L, H, K, carried, cot = CASES[case]
    xs, dy, ds = _inputs(B, L, H, K, carried, cot, seed=5 * L + K)
    tx = [torch.from_numpy(x) for x in xs]
    tdy = torch.from_numpy(dy)
    tds = None if ds is None else torch.from_numpy(ds)
    ckpt = wkv6_ref.wkv6_ckpt_ref(tx[1], tx[2], tx[3], tx[5])
    none = wkv6_ops.wkv6_bwd(*tx, tdy, tds)
    given = wkv6_ops.wkv6_bwd(*tx, tdy, tds, ckpt=ckpt)
    leaves = [x.clone().requires_grad_() for x in tx]
    y, S = wkv6_ops.wkv6(*leaves)
    outs, cots = [y], [tdy]
    if tds is not None:
        outs.append(S)
        cots.append(tds)
    auto = torch.autograd.grad(outs, leaves, cots)
    for name, a, b, c in zip(NAMES, none, given, auto):
        assert torch.equal(a, b) and torch.equal(a, c), name
    other = wkv6_ref.wkv6_ckpt_ref(tx[1], tx[2], tx[3], tx[5] + 1.0)
    moved = wkv6_ops.wkv6_bwd(*tx, tdy, tds, ckpt=other)
    assert not all(torch.equal(a, b) for a, b in zip(none, moved))
