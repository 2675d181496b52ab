"""AdamW and the train step held against the JAX package: ``schedule`` and
``global_norm``; ``apply_updates`` over 3 steps with f32 and bf16
moments, weight decay by leaf name and the global-norm clip active (the
gradients' norm far above ``grad_clip``); ``make_train_step`` with accum 1
and 2 on the reduced fp32 qwen3 from the reference's parameters; and the
port's copy of the reference's ``test_loss_decreases_tiny_train``.

Tolerances: the learning rate and the bias corrections at 1e-7 (both in
f32); parameters and f32 moments after 3 updates within 1e-6 of the
largest value of their leaf (the f32 sums of the global norm in another
order); bf16 moments within one bf16 ulp (2^-8 relative: an f32 moment
within an ulp of a rounding boundary may round the other way); the train
step's loss and grad norm at 1e-5 relative, its first moments within
1e-4 of their largest, and its parameters within 1e-5 wherever |g| >= 100
eps (Adam's first update, lr g / (|g| + eps), turns on a gradient's last
bits where |g| is near eps; there a parameter is only held within the
update's range).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.steps import make_train_step as j_make_train_step
from repro.training import optimizer as jopt
from repro_torch import weights
from repro_torch.configs.base import get_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm as TLM
from repro_torch.training import optimizer as opt
from test_torch_train_forward import both, make_batch

torch.set_num_threads(2)


def _tree(rng):
    """Leaves named as the models' (decayed: w, embed, lora_a; not decayed:
    scale, bias, ln, norm, dt_bias), one of them bf16."""
    def a(*shape):
        return rng.normal(size=shape).astype(np.float32)
    return {"embed": a(16, 8), "final_norm": {"scale": a(8)},
            "blocks": [{"wq": a(8, 8), "bq": a(8), "ln1": {"scale": a(8),
                                                           "bias": a(8)},
                        "dt_bias": a(4), "lora_a": a(2, 8, 3)}
                       for _ in range(2)],
            "wide": a(5, 7).astype(jnp.bfloat16)}


def _to_torch(tree):
    return weights.to_torch(tree, "cpu") if isinstance(tree, dict) else tree


def _leaves(tree):
    return [np.asarray(x.float() if isinstance(x, torch.Tensor) else
                       np.asarray(x).astype(np.float32))
            for _, x in opt.tree_leaves(tree)]


def test_decay_mask_by_leaf_name():
    assert opt._decay_mask(("blocks", 0, "attn", "wq"))
    assert opt._decay_mask(("shared_attn", "lora_a"))
    for name in ("scale", "bias", "dt_bias", "q_norm", "ln_x"):
        assert not opt._decay_mask(("blocks", 1, name))


def test_schedule_and_global_norm_match_jax():
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=50,
                          min_lr_frac=0.1)
    jcfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=50,
                            min_lr_frac=0.1)
    for step in (0, 1, 5, 10, 11, 30, 50, 70):
        np.testing.assert_allclose(
            float(opt.schedule(cfg, step)),
            float(jopt.schedule(jcfg, jnp.asarray(step))), rtol=1e-7)
    tree = _tree(np.random.default_rng(0))
    np.testing.assert_allclose(float(opt.global_norm(_to_torch(tree))),
                               float(jopt.global_norm(tree)), rtol=1e-6)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_apply_updates_three_steps_match_jax(moment_dtype):
    rng = np.random.default_rng(1)
    jp = _tree(rng)
    tp = _to_torch(jp)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              grad_clip=1.0, moment_dtype=moment_dtype)
    jcfg, tcfg = jopt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    jst = jopt.init_state(jp, moment_dtype)
    tst = opt.init_state(tp, moment_dtype)
    for _ in range(3):
        g = jax.tree.map(lambda x: (rng.normal(size=x.shape) * 10).astype(
            np.float32).astype(x.dtype), jp)
        jp, jst, jm = jopt.apply_updates(jp, g, jst, jcfg)
        tp, tst, tm = opt.apply_updates(tp, _to_torch(g), tst, tcfg)
        assert float(jm["grad_norm"]) > 10 * kw["grad_clip"]   # clipped
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
    assert tst.step == int(jst.step) == 3
    for name, t, j in (("params", tp, jp), ("m", tst.m, jst.m),
                       ("v", tst.v, jst.v)):
        for (path, x), y in zip(opt.tree_leaves(t), _leaves(j)):
            x = x.float().numpy()
            if name != "params" and moment_dtype == "bfloat16":
                np.testing.assert_allclose(x, y, rtol=2 ** -8, atol=1e-30,
                                           err_msg=str(path))
            else:
                np.testing.assert_allclose(
                    x, y, atol=1e-6 * max(np.abs(y).max(), 1e-30),
                    err_msg=f"{name} {path}")
    # decay by name is held by the params above: a leaf decayed in one
    # package and not in the other would differ by lr x wd x |p| ~ 1e-3
    assert tst.m["final_norm"]["scale"].dtype == getattr(torch,
                                                         moment_dtype)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    cfg, jcfg, jp, tp = both("qwen3-14b", seed=3)
    b = make_batch(cfg, np.random.default_rng(6), 4, 16, labels=True)
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=30)
    jstep = jax.jit(j_make_train_step(jcfg, accum=accum,
                                      optc=jopt.AdamWConfig(**kw),
                                      ce_chunk=8))
    jp2, jst, jm = jstep(jp, jopt.init_state(jp),
                         {k: jnp.asarray(v) for k, v in b.items()})
    step = make_train_step(cfg, accum=accum, optc=opt.AdamWConfig(**kw),
                           ce_chunk=8)
    tp2, tst, tm = step(tp, opt.init_state(tp),
                        {k: torch.from_numpy(v) for k, v in b.items()})
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    ref, mref = (weights.convert_lm(jax.tree.map(np.asarray, t), cfg,
                                    device="cpu") for t in (jp2, jst.m))
    top = max(float(y.abs().max()) for _, y in opt.tree_leaves(mref))
    for (path, x), (_, y), (_, m), (_, mr) in zip(
            opt.tree_leaves(tp2), opt.tree_leaves(ref),
            opt.tree_leaves(tst.m), opt.tree_leaves(mref)):
        np.testing.assert_allclose(m.numpy(), mr.numpy(), atol=1e-4 * top,
                                   err_msg=str(path))
        # the first update is about lr g / (|g| + eps): where |g| is near
        # eps it turns on the gradient's last bits, and may move the
        # parameter anywhere in its +-lr (1 + weight decay) range
        lim = np.where(np.abs(mr.numpy()) / (1 - 0.9) >= 100 * 1e-8, 1e-5,
                       2 * kw["lr"] * 1.1)
        assert (np.abs(x.numpy() - y.numpy()) <= lim).all(), path


def test_loss_decreases_tiny_train():
    """The reference's ``test_loss_decreases_tiny_train`` on the port: a few
    steps of the real train step on the reduced qwen3 (bf16) memorising a
    fixed batch; the loss must fall."""
    cfg = get_config("qwen3-14b").reduced().replace(remat=False)
    params = TLM.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    state = opt.init_state(params)
    step = make_train_step(cfg, optc=opt.AdamWConfig(
        lr=3e-3, warmup_steps=1, total_steps=30), ce_chunk=16)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        cfg, np.random.default_rng(0), 4, 16, labels=True).items()}
    losses = []
    for _ in range(8):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]
    assert params["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_update_leaf_in_row_blocks_gives_the_same_bits(moment_dtype,
                                                       monkeypatch):
    """A leaf past ``UPDATE_CHUNK`` elements is updated a block of its
    leading rows at a time (its f32 temporaries bounded: command-r-35b's
    2.1 B-parameter embedding on one card): the same bits as one pass,
    for the parameter and both moments, decayed leaves or not."""
    rng = np.random.default_rng(0)
    mdt = getattr(torch, moment_dtype)
    scalars = opt.update_scalars(opt.AdamWConfig(), 3,
                                 torch.tensor(2.5, dtype=torch.float32))
    for path, shape, gdt in ((("blocks", 0, "w"), (37, 11), torch.float32),
                             (("embed",), (50, 3, 4), torch.bfloat16),
                             (("ln", "scale"), (45,), torch.bfloat16),
                             (("x",), (), torch.float32)):
        p0 = torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(torch.bfloat16)
        g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(gdt)
        m0, v0 = (torch.from_numpy(rng.uniform(0, 1, shape)
                                   .astype(np.float32)).to(mdt)
                  for _ in range(2))
        outs = []
        for chunk in (1 << 26, 7, 1):
            monkeypatch.setattr(opt, "UPDATE_CHUNK", chunk)
            p, m, v = p0.clone(), m0.clone(), v0.clone()
            opt.update_leaf(path, p, g, m, v, scalars, opt.AdamWConfig())
            outs.append((p, m, v))
        for p, m, v in outs[1:]:
            for a, b in zip((p, m, v), outs[0]):
                assert torch.equal(a.reshape(-1).view(torch.uint8),
                                   b.reshape(-1).view(torch.uint8))
        assert not torch.equal(outs[0][1], m0)     # an update was made
