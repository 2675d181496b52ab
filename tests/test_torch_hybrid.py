"""The hybrid kind (zamba2-7b: Mamba2 layers and one weight-shared attention
+ MLP block with a LoRA on q per invocation) of the port's LM held against
the JAX package, the reference's parameters carried over by
``repro_torch.weights``: prefill and decode logits, the state and k/v
caches key for key, bf16 weight conversion, greedy tokens through both
packages' ModelEngines, and the invocation schedule. The helpers and the
tolerances are ``tests/test_torch_ssm.py``'s.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import lm as JLM
from repro_torch import weights
from repro_torch.configs.base import get_config
from repro_torch.models import lm as TLM

from test_torch_ssm import (bf16_converts_bit_for_bit, engine_tokens,
                            run_both)

torch.set_num_threads(2)

CPU = "cpu"
ARCH = "zamba2-7b"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba2_prefill_and_decode_match_jax(dtype):
    """A 37-token prompt (over two chunks of 16, padded to 48), then 8
    decode steps: the shared block's k/v land at positions 0-44 of both
    invocations' caches."""
    run_both(ARCH, dtype, seed=0)


def test_zamba2_decode_reads_this_steps_token_for_x0(monkeypatch):
    """x0, the shared block's second input, is the embedding of the token
    being decoded, not the prompt's."""
    cfg = get_config(ARCH).reduced().replace(dtype="float32")
    jcfg = j_get_config(ARCH).reduced().replace(dtype="float32")
    jp = JLM.init_params(jax.random.PRNGKey(5), jcfg)
    tp = weights.convert_lm(jax.tree.map(np.asarray, jp), cfg, device=CPU)
    seen = []
    real = TLM._zamba_shared_fwd

    def spy(sp, cfg_, x, x0, inv, *rest):
        seen.append((inv, x0.clone()))
        return real(sp, cfg_, x, x0, inv, *rest)
    monkeypatch.setattr(TLM, "_zamba_shared_fwd", spy)
    cache = TLM.init_cache(cfg, 2, 16, device=CPU)
    TLM.prefill(tp, cfg, {"tokens": torch.tensor([[1, 2, 3], [4, 5, 6]])},
                cache)
    tok = torch.tensor([[7], [9]])
    TLM.decode_step(tp, cfg, tok, cache, torch.tensor([3, 3]))
    n_inv = cfg.n_layers // cfg.attn_every
    assert [inv for inv, _ in seen] == list(range(n_inv)) * 2
    for _, x0 in seen[n_inv:]:
        torch.testing.assert_close(x0, TLM.embed_tokens(tp, cfg, tok),
                                   rtol=0, atol=0)


def test_zamba2_bf16_weights_convert_bit_for_bit():
    """``shared_attn`` comes over with its LoRA stacked by invocation; the
    Mamba2 layers' A_log, D and dt_bias stay f32."""
    assert bf16_converts_bit_for_bit(ARCH) == 3 * get_config(
        ARCH).reduced().n_layers
    jcfg = j_get_config(ARCH).reduced()
    tp = weights.convert_lm(
        jax.tree.map(np.asarray, JLM.init_params(jax.random.PRNGKey(1), jcfg)),
        get_config(ARCH).reduced(), device=CPU)
    n_inv = jcfg.n_layers // jcfg.attn_every
    assert tp["shared_attn"]["lora_a"].shape == (
        n_inv, 2 * jcfg.d_model, jcfg.shared_lora_rank)


def test_zamba2_engine_greedy_tokens_match_jax():
    """Three slots, prompts of 37 (over two chunks), 21 and 6 tokens."""
    engine_tokens(ARCH, 6, (37, 21, 6))


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_cache_leaves_at_full_size(arch):
    """The full configs' cache layout, from shapes alone (meta tensors):
    rwkv6's f32 state and bf16 carries; zamba2's 13 invocations (layers 5,
    11, ..., 77) of 32 heads of 112."""
    cfg = get_config(arch)
    c = TLM.init_cache(cfg, 4, 8192, device="meta")
    n = cfg.n_layers
    if arch == "rwkv6-7b":
        assert {k: tuple(v.shape) for k, v in c.items()} == {
            "s": (n, 4, 64, 64, 64), "tm_x": (n, 4, 4096),
            "cm_x": (n, 4, 4096)}
    else:
        assert {k: tuple(v.shape) for k, v in c.items()} == {
            "s": (n, 4, 112, 64, 64), "conv": (n, 4, 3, 7168 + 128),
            "ak": (13, 4, 8192, 32, 112), "av": (13, 4, 8192, 32, 112)}
        assert [i for i in range(n) if TLM._invocation(cfg, i) is not None] \
            == list(range(5, 81, 6))
    assert c["s"].dtype == torch.float32
