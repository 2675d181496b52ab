"""Config-driven LM (port of ``repro/models/lm.py``): the dense and MoE
kinds with GQA (optional ``qk_norm``, ``qkv_bias``) or MLA (multi-head
latent attention over a latent cache, deepseek's leading dense layers in
``first_dense_layers``), sliding windows over a ring KV cache, the VLM
prefix-LM (patch embeddings before the text, attended bidirectionally) and
the encoder-decoder (whisper: an encoder over stub frame embeddings,
cross-attention in every decoder layer, LayerNorm and the ungated gelu
MLP); gated MLP, RMSNorm, padded-vocab unembedding.

Public entry points:
    init_params(gen, cfg, device)               -> params
    forward(params, cfg, batch)                 -> (logits, aux_loss)
    forward_features(params, cfg, batch)       -> (features, aux, prefix_len)
    init_cache(cfg, batch, max_len, dtype, device) -> cache
    prefill(params, cfg, batch, cache)          -> (last_logits, cache)
    decode_step(params, cfg, tokens, cache, pos, kv_len) -> (logits, cache)

``batch`` is a dict: ``tokens`` (B, L), plus ``patch_embed`` (B, P, d) for
the VLM kind and ``frames`` (B, enc_len, d) for the encoder-decoder. Params
are nested dicts; the reference's layer-stacked ``blocks`` and
``enc_blocks`` pytrees are lists of per-layer dicts here
(``repro_torch.weights`` converts); ``dense0`` is a list in both. The KV
cache is updated in place (the reference returns a new pytree); it holds
``dense0``'s layers first, then ``blocks``'.

The SSM kind (rwkv6: ``models.ssm``'s RWKV6 layers, whose WKV recurrence
is the K5 kernel on the card) caches per layer the f32 state ``s`` (n, B,
H, K, K) and the last normalised inputs of the time and channel mixes,
``tm_x`` and ``cm_x`` (n, B, d); its prefill starts from zero state, as
the reference's does, whatever cache it is given. The hybrid kind (zamba2:
Mamba2 layers, and after every ``attn_every``-th of them, for the first
``n_layers // attn_every``, the one weight-shared attention + MLP block
over ``cat([x, x0])`` with a LoRA on q per invocation) caches ``s`` (n, B,
H, N, P) f32, ``conv`` (n, B, k-1, d_inner + 2N) and the shared block's
k/v per invocation, ``ak``/``av`` (n_inv, B, Lc, H, Dh): prefill runs K4
causal over the prompt, decode K3 over ``ak[inv]``/``av[inv]``. In decode
``x0`` is this step's token embedding, as in the reference.

MLA caches ``latent`` (n, B, Lc, kv_lora_rank) and ``krope`` (n, B, Lc,
qk_rope_dim) in the model dtype, also when ``kv_dtype`` is int8, as the
reference does. Prefill materialises per-head K/V and runs K4's Dv mode;
decode runs the absorbed f32 products with ``mla_absorb``, else
materialises K/V and runs K3's Dv mode (``layers.mla_decode``).

A config with a ``window`` keeps a ring of ``cache_len`` positions: prefill
stores the trailing ``Lc`` positions with token t at slot t % Lc, decode
writes at pos % Lc and attends over min(kv_len, Lc) slots with no window
(the ring bounds it), as the reference does.

``kv_dtype="int8"`` keeps the reference's int8 KV cache: int8 codes with a
per-(position, head) f16 scale (``kv_quant``). On the card, decode hands
the codes and scales straight to the K3 kernel; on the CPU it dequantizes
into the model dtype first, as the reference model does.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

Params = dict[str, Any]


def _dtype(cfg: ModelConfig):
    return getattr(torch, cfg.dtype)


def _main_kind(cfg: ModelConfig) -> str:
    if cfg.is_encoder_decoder:
        return "decoder"
    if cfg.ssm_kind in ("rwkv6", "mamba2"):
        return cfg.ssm_kind
    return "moe" if cfg.is_moe else "dense"


def _norm_init(cfg, d: int, dtype, device) -> Params:
    return (L.layernorm_init(d, dtype, device) if cfg.family == "audio"
            else L.rmsnorm_init(d, dtype, device))


def _norm(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    return L.layernorm(p, x) if cfg.family == "audio" else L.rmsnorm(p, x)


def _block_init(gen, cfg: ModelConfig, kind: str, dtype, device) -> Params:
    """kind: "dense", "moe", "decoder" (with cross-attention), "rwkv6" or
    "mamba2"."""
    if kind == "rwkv6":
        return S.rwkv6_init(gen, cfg, dtype, device)
    if kind == "mamba2":
        return S.mamba2_init(gen, cfg, dtype, device)
    p: Params = {"ln1": _norm_init(cfg, cfg.d_model, dtype, device),
                 "attn": (L.mla_init if cfg.attn_kind == "mla"
                          else L.gqa_init)(gen, cfg, dtype, device),
                 "ln2": _norm_init(cfg, cfg.d_model, dtype, device)}
    if kind == "moe":
        p["mlp"] = L.moe_init(gen, cfg, dtype, device)
    else:
        gated = cfg.act != "gelu" or cfg.family == "vlm"
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device,
                              gated=gated)
    if kind == "decoder":
        p["ln_x"] = _norm_init(cfg, cfg.d_model, dtype, device)
        p["xattn"] = L.gqa_init(gen, cfg, dtype, device)
    return p


def _zamba_shared_init(gen, cfg, dtype, device) -> Params:
    """Zamba2's weight-shared (attention + MLP) block over cat([x, x0]),
    with a LoRA delta on q for each of its n_layers // attn_every
    invocations, stacked along a leading axis as in the reference."""
    d2, H, Dh = 2 * cfg.d_model, cfg.n_heads, cfg.head_dim
    n_inv, r = cfg.n_layers // cfg.attn_every, cfg.shared_lora_rank

    def dense(d_in, d_out):
        return L.dense_init(gen, d_in, d_out, dtype, device)
    lora_a = torch.randn((n_inv, d2, r), generator=gen, dtype=torch.float32,
                         device=device) * 0.01
    return {"ln": L.rmsnorm_init(d2, dtype, device),
            "wq": dense(d2, H * Dh), "wk": dense(d2, H * Dh),
            "wv": dense(d2, H * Dh), "wo": dense(H * Dh, cfg.d_model),
            "ln2": L.rmsnorm_init(cfg.d_model, dtype, device),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
            "lora_a": lora_a.to(dtype),
            "lora_b": torch.zeros((n_inv, r, H * Dh), dtype=dtype,
                                  device=device)}


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    d = cfg.d_model
    emb = torch.randn((cfg.padded_vocab, d), generator=gen,
                      dtype=torch.float32, device=dev) * 0.02
    p: Params = {"embed": emb.to(dtype),
                 "final_norm": _norm_init(cfg, d, dtype, dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, d, cfg.padded_vocab, dtype, dev,
                                    scale=0.02)
    kind = _main_kind(cfg)
    p["blocks"] = [_block_init(gen, cfg, kind, dtype, dev)
                   for _ in range(cfg.n_layers - cfg.first_dense_layers)]
    if cfg.first_dense_layers:
        p["dense0"] = [_block_init(gen, cfg, "dense", dtype, dev)
                       for _ in range(cfg.first_dense_layers)]
    if cfg.is_encoder_decoder:
        p["enc_blocks"] = [_block_init(gen, cfg, "dense", dtype, dev)
                           for _ in range(cfg.enc_layers)]
        p["enc_norm"] = _norm_init(cfg, d, dtype, dev)
    if cfg.family == "hybrid":
        p["shared_attn"] = _zamba_shared_init(gen, cfg, dtype, dev)
    return p


def _layers(p: Params) -> list:
    """The decoder stack in cache order: ``dense0``'s layers, then
    ``blocks``'."""
    return p.get("dense0", []) + p["blocks"]


def embed_tokens(p: Params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    x = p["embed"][tokens.long()]
    if cfg.family == "vlm":     # gemma: sqrt(d) rounded to the dtype first
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _assemble_input(p: Params, cfg, batch: dict) -> tuple[torch.Tensor, int]:
    """tokens (after the VLM's patch embeddings) -> (x (B, L, d),
    prefix_len: how many leading positions attend bidirectionally)."""
    x = embed_tokens(p, cfg, batch["tokens"])
    if cfg.family == "vlm":
        x = torch.cat([batch["patch_embed"].to(x.dtype), x], dim=1)
        return x, cfg.prefix_len
    return x, 0


def unembed(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    logits = x @ (p["embed"].T if cfg.tie_embeddings else p["lm_head"])
    if cfg.padded_vocab != cfg.vocab_size:
        cols = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(cols >= cfg.vocab_size,
                                    torch.finfo(logits.dtype).min)
    return logits


def _block(bp: Params, cfg, x, attend, moe_groups: int = 1, cross=None,
           aux: Optional[list] = None):
    """Pre-norm block; ``attend(h) -> attention output`` supplies the
    training, prefill or decode attention, ``cross(h)`` a decoder layer's
    cross-attention (after ``ln_x``). An MoE block dispatches its tokens in
    ``moe_groups`` groups along the batch (``L.moe_apply``) and appends its
    load-balancing loss to ``aux`` when one is given."""
    h = _norm(cfg, bp["ln1"], x)
    x = x + attend(h)
    if cross is not None:
        x = x + cross(_norm(cfg, bp["ln_x"], x))
    h = _norm(cfg, bp["ln2"], x)
    if "router" in bp["mlp"]:
        m, a = L.moe_apply(bp["mlp"], cfg, h, groups=moe_groups)
        if aux is not None:
            aux.append(a)
        return x + m
    return x + L.mlp(bp["mlp"], h, cfg.act)


def _remat(cfg, fn, *args):
    """``fn(*args)``, its activations recomputed in the backward
    (``torch.utils.checkpoint``) when ``cfg.remat`` is set and grad mode is
    on: the reference's ``jax.checkpoint`` of each scan body."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _cross(bp: Params, cfg, h: torch.Tensor, memory: torch.Tensor):
    """A decoder layer's cross-attention from h (B, L, d) over the
    encoder's output: (its output (B, L, d), the memory's k, v)."""
    q = L.gqa_q(bp["xattn"], cfg, h)
    mpos = torch.arange(memory.shape[1], device=h.device)
    _, mk, mv = L.gqa_qkv(bp["xattn"], cfg, memory, mpos, rope=False)
    a = L.flash_attention(q, mk, mv, causal=False)
    return a.reshape(*h.shape[:2], -1) @ bp["xattn"]["wo"], mk, mv


def _encode(p: Params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """The encoder over stub frame embeddings (B, enc_len, d): bidirectional
    self-attention (K4, non-causal), then ``enc_norm``."""
    x = L.dp_constrain(frames.to(_dtype(cfg)), cfg.act_dp)
    positions = torch.arange(x.shape[1], device=x.device)

    def body(x, bp):
        x = L.dp_constrain(x, cfg.act_dp)
        return _block(bp, cfg, x, lambda h: L.gqa_attend(
            bp["attn"], cfg, h, positions, causal=False))
    for bp in p["enc_blocks"]:
        x = _remat(cfg, body, x, bp)
    return _norm(cfg, p["enc_norm"], x)


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------


def forward(p: Params, cfg: ModelConfig, batch: dict
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward: (logits (B, L, V) over the token positions, the
    MoE aux loss (f32 scalar, 0 without MoE))."""
    x, aux, prefix_len = forward_features(p, cfg, batch)
    logits = unembed(p, cfg, x)
    if cfg.family == "vlm":
        logits = logits[:, prefix_len:]
    return logits, aux


def forward_features(p: Params, cfg: ModelConfig, batch: dict
                     ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The forward up to and including the final norm, no unembedding:
    (features (B, Lx, d), aux loss, prefix_len). The train step's chunked
    cross-entropy unembeds them a sequence chunk at a time. Every kind:
    dense and MoE (summing each MoE layer's aux loss), ``dense0``, the VLM
    prefix, the encoder-decoder (``_encode``, then cross-attention in every
    layer), rwkv6 and the mamba2 hybrid (``_hybrid_forward``), each from
    zero state. With ``cfg.remat`` each layer is recomputed in the
    backward."""
    x, prefix_len = _assemble_input(p, cfg, batch)
    x = L.dp_constrain(x, cfg.act_dp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.ssm_kind == "rwkv6":
        def body(x, bp):
            x = L.dp_constrain(x, cfg.act_dp)
            return S.rwkv6_block(bp, cfg, x, None, cfg.chunk_size)[0]
        for bp in p["blocks"]:
            x = _remat(cfg, body, x, bp)
    elif cfg.ssm_kind == "mamba2":
        x = _hybrid_forward(p, cfg, x)
    else:
        positions = torch.arange(x.shape[1], device=x.device)
        memory = (_encode(p, cfg, batch["frames"]) if cfg.is_encoder_decoder
                  else None)

        def attend(bp, h):
            if cfg.attn_kind == "mla":
                latent, krope = L.mla_latent(bp["attn"], cfg, h, positions)
                return L.mla_attend(bp["attn"], cfg, h, positions, latent,
                                    krope)
            return L.gqa_attend(bp["attn"], cfg, h, positions, causal=True,
                                prefix_len=prefix_len)

        def body(x, bp):
            x = L.dp_constrain(x, cfg.act_dp)
            auxes: list = []
            x = _block(bp, cfg, x, lambda h: attend(bp, h),
                       cross=None if memory is None
                       else lambda h: _cross(bp, cfg, h, memory)[0],
                       aux=auxes)
            return x, sum(auxes, torch.zeros_like(aux))
        for bp in _layers(p):
            x, a = _remat(cfg, body, x, bp)
            aux = aux + a
    return _norm(cfg, p["final_norm"], x), aux, prefix_len


def _hybrid_forward(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Zamba2's training forward: the Mamba2 layers from zero state, the
    shared attention + MLP block over cat([x, x0]) after the layers
    ``_invocation`` names, x0 the embedded input; each layer with its
    shared block one recomputed unit under ``cfg.remat``."""
    x0 = x
    positions = torch.arange(x.shape[1], device=x.device)

    def body(x, bp, inv):
        x = L.dp_constrain(x, cfg.act_dp)
        x = S.mamba2_block(bp, cfg, x, None, cfg.chunk_size)[0]
        if inv is None:
            return x
        return _zamba_shared_fwd(p["shared_attn"], cfg, x, x0, inv,
                                 positions, None, None)
    for i, bp in enumerate(p["blocks"]):
        x = _remat(cfg, body, x, bp, _invocation(cfg, i))
    return x


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Ring-buffer length for SWA archs, else max_len."""
    if cfg.window is not None:
        return min(cfg.window, max_len)
    return max_len


kv_dequant = L.kv_dequant


def kv_quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., H, D) -> (int8 codes, f16 per-(..., H) symmetric scale). The
    codes come from the f32 scale, which is then stored as f16 (the
    reference's ``kv_quant``; ``torch.round`` rounds half to even, as
    ``jnp.round`` does)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(xf / scale[..., None])
    return q.to(torch.int8), scale.to(torch.float16)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    n, Lc = cfg.n_layers, cache_len(cfg, max_len)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)
    if cfg.ssm_kind == "rwkv6":
        H, K = cfg.ssm_heads, cfg.ssm_head_dim
        return {"s": zeros((n, batch, H, K, K), torch.float32),
                "tm_x": zeros((n, batch, cfg.d_model)),
                "cm_x": zeros((n, batch, cfg.d_model))}
    if cfg.ssm_kind == "mamba2":
        H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
        cache = {"s": zeros((n, batch, H, N, P), torch.float32),
                 "conv": zeros((n, batch, cfg.conv_kernel - 1,
                                cfg.d_inner + 2 * N))}
        if cfg.attn_every:
            shape = (n // cfg.attn_every, batch, Lc, cfg.n_heads,
                     cfg.head_dim)
            cache["ak"], cache["av"] = zeros(shape), zeros(shape)
        return cache
    if cfg.attn_kind == "mla":
        return {"latent": torch.zeros((n, batch, Lc, cfg.kv_lora_rank),
                                      dtype=dtype, device=dev),
                "krope": torch.zeros((n, batch, Lc, cfg.qk_rope_dim),
                                     dtype=dtype, device=dev)}
    shape = (n, batch, Lc, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_dtype == "int8":
        # int8 codes + per-(position, head) f16 scales
        cache = {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                 "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                 "k_scale": torch.zeros(shape[:-1], dtype=torch.float16,
                                        device=dev),
                 "v_scale": torch.zeros(shape[:-1], dtype=torch.float16,
                                        device=dev)}
    else:
        cache = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if cfg.is_encoder_decoder:
        xshape = (n, batch, cfg.enc_len, cfg.n_heads, cfg.head_dim)
        cache["xk"] = torch.zeros(xshape, dtype=dtype, device=dev)
        cache["xv"] = torch.zeros(xshape, dtype=dtype, device=dev)
    return cache


def _write_kv(cache: Params, i: int, idx, k: torch.Tensor,
              v: torch.Tensor) -> None:
    """Store k/v (quantized for an int8 cache) at ``cache[key][i][idx]``."""
    if "k_scale" in cache:
        (kq, ks), (vq, vs) = kv_quant(k), kv_quant(v)
        cache["k_scale"][i][idx] = ks
        cache["v_scale"][i][idx] = vs
        k, v = kq, vq
    cache["k"][i][idx] = k.to(cache["k"].dtype)
    cache["v"][i][idx] = v.to(cache["v"].dtype)


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def _ring_place(kv: torch.Tensor, seq_len: int, ring_len: int
                ) -> torch.Tensor:
    """Align prefill's trailing-``ring_len`` slice (positions [seq_len -
    ring_len, seq_len)) with decode's pos % ring_len slots, so decode
    overwrites the oldest entry first."""
    if kv.shape[1] < ring_len or seq_len <= ring_len:
        return kv
    return torch.roll(kv, seq_len % ring_len, dims=1)


def _invocation(cfg: ModelConfig, i: int) -> Optional[int]:
    """The shared block's invocation after Mamba2 layer i, or None: after
    every ``attn_every``-th layer, for the first n_layers // attn_every."""
    every = cfg.attn_every
    if not every or i % every != every - 1 \
            or i // every >= cfg.n_layers // every:
        return None
    return i // every


def _zamba_shared_fwd(sp: Params, cfg, x, x0, inv: int, positions, k_cache,
                      v_cache, decode=None) -> torch.Tensor:
    """Zamba2's shared attention + MLP block, invocation ``inv``, over
    cat([x, x0]); q carries the invocation's LoRA delta, q and k RoPE. The
    (B, Lc, H, Dh) caches are written in place: in prefill (``decode``
    None) the prompt's k/v at positions [0, L), then causal attention over
    them (K4); in a decode step (``decode`` = (rows, pos, kv_len)) the
    token's k/v at (rows, pos), then attention over kv_len positions
    (K3). The training forward passes no caches (None)."""
    B = x.shape[0]
    H, Dh = cfg.n_heads, cfg.head_dim
    h = L.rmsnorm(sp["ln"], torch.cat([x, x0], dim=-1))
    q = h @ sp["wq"] + (h @ sp["lora_a"][inv]) @ sp["lora_b"][inv]
    q = L.apply_rope(q.reshape(B, -1, H, Dh), positions, cfg.rope_theta)
    k = L.apply_rope((h @ sp["wk"]).reshape(B, -1, H, Dh), positions,
                     cfg.rope_theta)
    v = (h @ sp["wv"]).reshape(B, -1, H, Dh)
    if decode is None:
        if k_cache is not None:
            k_cache[:, :k.shape[1]] = k.to(k_cache.dtype)
            v_cache[:, :v.shape[1]] = v.to(v_cache.dtype)
        a = L.flash_attention(q, k, v, causal=True)
    else:
        rows, pos, kv_len = decode
        k_cache[rows, pos] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, pos] = v[:, 0].to(v_cache.dtype)
        a = L.decode_attention(q, k_cache, v_cache, kv_len=kv_len)
    x = x + a.reshape(B, -1, H * Dh) @ sp["wo"]
    return x + L.mlp(sp["mlp"], L.rmsnorm(sp["ln2"], x), cfg.act)


def _ssm_stack(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Params,
               decode=None) -> torch.Tensor:
    """The SSM and hybrid kinds' layers over x (B, L, d), their states
    written into ``cache`` in place. Prefill (``decode`` None) starts every
    layer from zero state; a decode step (``decode`` = (rows, pos, kv_len),
    one token a row) carries each layer's state. The hybrid's shared block
    runs after the layers ``_invocation`` names (``_zamba_shared_fwd``)."""
    x0 = x
    positions = (torch.arange(x.shape[1], device=x.device) if decode is None
                 else decode[1][:, None])
    for i, bp in enumerate(p["blocks"]):
        st = None if decode is None else {
            key: cache[key][i] for key in cache if key not in ("ak", "av")}
        if cfg.ssm_kind == "rwkv6":
            x, st = S.rwkv6_block(bp, cfg, x, st, cfg.chunk_size)
        elif decode is None:
            x, st = S.mamba2_block(bp, cfg, x, None, cfg.chunk_size)
        else:
            x, st = S.mamba2_decode_step(bp, cfg, x, st)
        for key, val in st.items():
            cache[key][i] = val.to(cache[key].dtype)
        inv = _invocation(cfg, i)
        if inv is not None:
            x = _zamba_shared_fwd(p["shared_attn"], cfg, x, x0, inv,
                                  positions, cache["ak"][inv],
                                  cache["av"][inv], decode)
    return x


def prefill(p: Params, cfg: ModelConfig, batch: dict, cache: Params
            ) -> tuple[torch.Tensor, Params]:
    """Process the full prompt (``batch["tokens"]`` (B, L), after the VLM's
    ``patch_embed``; an encoder-decoder first encodes ``batch["frames"]``);
    write its K/V (MLA: latent and k_rope) into the cache in place:
    positions [0, L), or for a window the trailing ``cache_len`` positions
    placed for decode's ring (``_ring_place``), and a decoder layer's
    cross-attention K/V over the encoder's output in ``xk``/``xv``; return
    last-position logits. The SSM and hybrid kinds store their layers'
    final states instead (``_ssm_stack``)."""
    x, prefix_len = _assemble_input(p, cfg, batch)
    if cfg.ssm_kind:
        x = _ssm_stack(p, cfg, x, cache)
        logits = unembed(p, cfg, _norm(cfg, p["final_norm"], x[:, -1:]))
        return logits[:, 0], cache
    B, Lx, _ = x.shape
    Lc = cache_len(cfg, Lx)
    positions = torch.arange(Lx, device=x.device)
    memory = (_encode(p, cfg, batch["frames"]) if cfg.is_encoder_decoder
              else None)
    head = (slice(None), slice(0, Lc))

    def ring(t):
        return _ring_place(t[:, -Lc:], Lx, Lc)

    for i, bp in enumerate(_layers(p)):
        def attend(h, bp=bp, i=i):
            if cfg.attn_kind == "mla":
                latent, krope = L.mla_latent(bp["attn"], cfg, h, positions)
                cache["latent"][i][head] = ring(latent).to(
                    cache["latent"].dtype)
                cache["krope"][i][head] = ring(krope).to(
                    cache["krope"].dtype)
                return L.mla_attend(bp["attn"], cfg, h, positions, latent,
                                    krope)
            q, k, v = L.gqa_qkv(bp["attn"], cfg, h, positions)
            a = L.flash_attention(q, k, v, causal=True, window=cfg.window,
                                  prefix_len=prefix_len)
            _write_kv(cache, i, head, ring(k), ring(v))
            return a.reshape(B, Lx, -1) @ bp["attn"]["wo"]

        def cross(h, bp=bp, i=i):
            out, mk, mv = _cross(bp, cfg, h, memory)
            cache["xk"][i] = mk.to(cache["xk"].dtype)
            cache["xv"][i] = mv.to(cache["xv"].dtype)
            return out
        x = _block(bp, cfg, x, attend,
                   cross=cross if memory is not None else None)
    logits = unembed(p, cfg, _norm(cfg, p["final_norm"], x[:, -1:]))
    return logits[:, 0], cache


def decode_step(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, pos, kv_len: Optional[torch.Tensor] = None,
                *, moe_groups: int = 1, kv_max: Optional[int] = None
                ) -> tuple[torch.Tensor, Params]:
    """One decode step. tokens: (B, 1); pos: the token's position, an int
    or a (B,) tensor (one position per slot — the reference vmaps a scalar
    pos over slots); kv_len: (B,) valid lengths (default pos + 1). With a
    window the k/v go to ring slot pos % Lc and attention reads
    min(kv_len, Lc) slots. Returns (logits (B, V), cache), the cache
    updated in place. kv_len goes to every layer's attention as int32,
    converted here once a step (not once a layer) when it comes in another
    type.

    ``moe_groups``: an MoE layer dispatches the B rows in that many groups,
    each with its own capacity (``L.moe_apply``). The default, one group,
    takes the capacity from all B tokens, as the reference's decode_step
    does; ``ModelEngine`` passes B, as the reference engine's decode
    vmapped over slots computes (each slot its own T = 1 dispatch).

    ``kv_max``: the largest kv_len, when the caller knows it on the host
    (``ModelEngine`` does): MLA decode then reads or materialises only the
    first kv_max cache positions, which gives the same result. An
    encoder-decoder's cross-attention reads all ``enc_len`` positions of
    ``xk``/``xv``.

    The SSM and hybrid kinds carry each layer's state; the hybrid's shared
    block writes its k/v at pos and reads kv_len positions (K3)."""
    B = tokens.shape[0]
    dev = tokens.device
    mla = cfg.attn_kind == "mla"
    pos = torch.as_tensor(pos, device=dev).long().expand(B)
    kv_len = (pos + 1 if kv_len is None else kv_len).to(torch.int32)
    rows = torch.arange(B, device=dev)
    if cfg.ssm_kind:
        x = _ssm_stack(p, cfg, embed_tokens(p, cfg, tokens), cache,
                       decode=(rows, pos, kv_len))
        logits = unembed(p, cfg, _norm(cfg, p["final_norm"], x))
        return logits[:, 0], cache
    write = pos
    if cfg.window is not None:      # the ring already bounds the window
        Lc = cache["latent" if mla else "k"].shape[2]
        write = pos % Lc
        kv_len = kv_len.clamp_max(Lc)
        kv_max = None if kv_max is None else min(kv_max, Lc)
    positions = pos[:, None]                                  # (B, 1)
    if cfg.is_encoder_decoder:
        enc_len = torch.full((B,), cache["xk"].shape[2], dtype=torch.int32,
                             device=dev)

    def scale(kv, i):
        s = cache.get(f"{kv}_scale")
        return None if s is None else s[i]

    x = embed_tokens(p, cfg, tokens)
    for i, bp in enumerate(_layers(p)):
        def attend(h, bp=bp, i=i):
            if mla:
                latent, krope = L.mla_latent(bp["attn"], cfg, h, positions)
                cache["latent"][i][rows, write] = latent[:, 0].to(
                    cache["latent"].dtype)
                cache["krope"][i][rows, write] = krope[:, 0].to(
                    cache["krope"].dtype)
                return L.mla_decode(bp["attn"], cfg, h, cache["latent"][i],
                                    cache["krope"][i], kv_len, positions,
                                    kv_max=kv_max)
            q, k, v = L.gqa_qkv(bp["attn"], cfg, h, positions)
            _write_kv(cache, i, (rows, write), k[:, 0], v[:, 0])
            a = L.decode_attention(q, cache["k"][i], cache["v"][i],
                                   kv_len=kv_len, k_scale=scale("k", i),
                                   v_scale=scale("v", i))
            return a.reshape(B, 1, -1) @ bp["attn"]["wo"]

        def cross(h, bp=bp, i=i):
            q = L.gqa_q(bp["xattn"], cfg, h)
            a = L.decode_attention(q, cache["xk"][i], cache["xv"][i],
                                   kv_len=enc_len)
            return a.reshape(B, 1, -1) @ bp["xattn"]["wo"]
        x = _block(bp, cfg, x, attend, moe_groups=moe_groups,
                   cross=cross if cfg.is_encoder_decoder else None)
    logits = unembed(p, cfg, _norm(cfg, p["final_norm"], x))
    return logits[:, 0], cache


def n_params(p: Params) -> int:
    """Parameter count of a params tree."""
    if isinstance(p, torch.Tensor):
        return p.numel()
    items = p.values() if isinstance(p, dict) else p
    return sum(n_params(v) for v in items)

