"""The int8 all-reduce's error against the exact mean, the port's and the
reference's, on the same gradients.

chip_smoke's phase 14 (c) read the int8 all-reduce's error of qwen3-14b's
full-width gradient as 0.0402 of the exact mean (the reference's own
test bound is 0.05). Both packages quantise a whole tensor under ONE
scale, the ranks' largest |x| over 127, and sum int32 codes: a leaf
whose largest entry is hundreds of times its rms puts most entries
within a few quantisation steps of zero, and its error is a large share
of its norm. Here the reference's ``compressed_psum`` (under
``jax.vmap`` with a named axis, which gives ``psum``/``pmax`` their
meaning on one CPU device) and the port's run on the same two ranks'
gradients, bf16 and f32 leaves whose largest entries are hundreds of
times their rms, at widths that fit; the whole tree's error is
phase 14 (c)'s measure, sqrt(sum err^2 / sum exact^2) with exact the f32
mean. The two packages' errors agree within rtol 1e-9 (the same codes;
the same bf16 rounding of the mean), and both are what one scale a
tensor predicts from the tensors' largest entries alone (rounding to a
step of max |x| / 127, within 10%): an error of this size is the
reference's scheme, not a fault of the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcomp
from repro_torch.distributed import compression

torch.set_num_threads(2)

AGREE_RTOL = 1e-9


def _grads(seed: int, shape, dtype, ratio: float):
    """Two ranks' gradients of one leaf: a shared heavy-tailed part and
    each rank's own, a few entries scaled so the largest |x| is about
    ``ratio`` times the rms."""
    rng = np.random.default_rng(seed)
    base = rng.standard_t(4, size=shape).astype(np.float32)
    gs = np.stack([base + 0.5 * rng.standard_normal(shape).astype(np.float32)
                   for _ in range(2)])
    flat = gs.reshape(2, -1)
    rms = float(np.sqrt((flat ** 2).mean()))
    hot = rng.choice(flat.shape[1], size=8, replace=False)
    flat[:, hot] = np.sign(flat[:, hot]) * ratio * rms
    if dtype == "bfloat16":     # the gradient as the model's dtype holds it
        gs = np.array(jnp.asarray(gs, jnp.bfloat16).astype(jnp.float32))
    return gs


def _errors(leaves, dtype):
    """(the reference's error, the port's, the largest |x| over the rms)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    err = {"ref": 0.0, "port": 0.0}
    ref2 = 0.0
    top = 0.0
    for gs in leaves:
        exact = gs.astype(np.float64).mean(axis=0)
        ref2 += float((exact ** 2).sum())
        top = max(top, float(np.abs(gs).max() / np.sqrt((gs ** 2).mean())))
        jout = jax.vmap(lambda x: jcomp.compressed_psum({"g": x}, "r")["g"],
                        axis_name="r")(jnp.asarray(gs, jdt))
        jmean = np.asarray(jout[0].astype(jnp.float32), np.float64)
        tout = compression.compressed_psum(
            [{"g": torch.from_numpy(gs[r]).to(tdt)} for r in range(2)])
        tmean = tout[0]["g"].float().numpy().astype(np.float64)
        assert torch.equal(tout[0]["g"], tout[1]["g"])
        err["ref"] += float(((jmean - exact) ** 2).sum())
        err["port"] += float(((tmean - exact) ** 2).sum())
    return (np.sqrt(err["ref"] / ref2), np.sqrt(err["port"] / ref2), top)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("ratio", [100.0, 400.0])
def test_int8_allreduce_error_is_the_references(dtype, ratio):
    leaves = [_grads(s, shape, dtype, ratio)
              for s, shape in enumerate(((1024, 512), (512, 1536),
                                         (4096,)))]
    e_ref, e_port, top = _errors(leaves, dtype)
    assert top >= 90.0              # about a hundred times the rms, or more
    assert abs(e_port - e_ref) <= AGREE_RTOL * e_ref, (e_port, e_ref)
    # one scale a tensor: the error grows with the largest entry's share
    assert 0.005 < e_ref < 1.0


def _scheme_error(leaves) -> float:
    """The error one global scale per tensor predicts: each rank's code
    rounds x / s, s the ranks' largest |x| over 127, to the nearest
    integer, an error uniform on (-s/2, s/2) of variance s^2 / 12; the
    mean of two ranks' codes times s has variance s^2 / 24 an entry."""
    num = den = 0.0
    for gs in leaves:
        s = float(np.abs(gs).max()) / 127.0
        num += gs[0].size * s * s / 24.0
        den += float((gs.astype(np.float64).mean(axis=0) ** 2).sum())
    return float(np.sqrt(num / den))


@pytest.mark.parametrize("ratio", [30.0, 100.0, 300.0])
def test_int8_allreduce_error_is_the_scale_s(ratio):
    """Both packages' error is what one scale per tensor predicts from the
    tensors' largest |x| alone, within 10%: the error is the scheme's."""
    leaves = [_grads(7 + s, shape, "float32", ratio)
              for s, shape in enumerate(((1024, 256), (256, 768)))]
    e_ref, e_port, _ = _errors(leaves, "float32")
    want = _scheme_error(leaves)
    assert abs(e_port - e_ref) <= AGREE_RTOL * e_ref
    assert abs(e_ref - want) <= 0.1 * want, (e_ref, want)
