"""``chunked_ce_loss`` gradients held against the reference's for the
mamba2 hybrid (zamba2: the shared block's LoRA per invocation, x0 the
embedded input), the encoder-decoder (whisper: the encoder's gradients
through cross-attention) and the VLM prefix-LM (paligemma: the loss over
the text span only, the prefix attended bidirectionally), and for
deepseek-v2's ``dense0`` + MoE; limits as in ``test_torch_train_grads``.
"""
import pytest
import torch

from test_torch_train_grads import grads_match

torch.set_num_threads(2)


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-base",
                                  "paligemma-3b", "deepseek-v2-236b"])
def test_chunked_ce_grads_match_jax(arch):
    grads_match(arch)
