"""Config system: architectures x input shapes.

Every assigned architecture is a ``ModelConfig`` (exact public-literature
numbers) registered under its id; shapes are ``ShapeConfig``s. The dry-run
enumerates the cross product; smoke tests use ``reduced()`` variants.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

# ---------------------------------------------------------------------------
# Shapes (assigned: 4 per LM arch)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio | embedder
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads

    # --- attention ---
    attn_kind: str = "gqa"  # gqa | mla | none
    qk_norm: bool = False
    qkv_bias: bool = False
    window: Optional[int] = None  # sliding-window attention width
    rope_theta: float = 1_000_000.0

    # --- MLA (multi-head latent attention) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mla_absorb: bool = False  # absorbed decode matmuls (beyond-paper perf)

    # --- MLP / MoE ---
    act: str = "silu"
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0  # deepseek: layer 0 dense
    capacity_factor: float = 1.25
    moe_impl: str = "scatter"  # scatter | einsum | shard_map
    # token-chunked MoE dispatch: bound the (E, C, d) buffer by processing
    # at most this many tokens per scan step (0 = single shot). §Perf A1.
    moe_chunk_tokens: int = 0
    # quantized KV cache ("int8"): halves decode HBM traffic + capacity
    # (per-position-per-head symmetric scales; KVQuant-style). §Perf C1.
    kv_dtype: str = ""

    # --- SSM ---
    ssm_kind: str = ""  # rwkv6 | mamba2
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    d_inner: int = 0
    conv_kernel: int = 4
    chunk_size: int = 64  # chunked linear-attention window

    # --- hybrid (zamba2) ---
    attn_every: int = 0  # shared attention block period (0 = none)
    shared_lora_rank: int = 0

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    enc_layers: int = 0
    enc_len: int = 1500

    # --- vlm (paligemma) ---
    prefix_len: int = 0  # image-patch prefix tokens (stub frontend)

    # --- misc ---
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    # data-parallel mesh axes to pin activations' batch dim to (set by
    # launch/steps.py when compiling distributed steps; () = no constraint)
    act_dp: tuple = ()
    # shapes this arch cannot run (with reason), per DESIGN.md
    skip_shapes: dict[str, str] = field(default_factory=dict)

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows padded to a multiple of 128 so the vocab
        dim shards evenly over any mesh axis <= 128 (MaxText-style);
        unembed() masks the pad columns so logits/CE are exact."""
        return (self.vocab_size + 127) // 128 * 128

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def active_params(self) -> int:
        """Approximate active parameter count (per-token), for 6ND."""
        return _param_count(self, active_only=True)

    @property
    def total_params(self) -> int:
        return _param_count(self, active_only=False)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw: dict = dict(
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads)) if self.n_kv_heads else 0,
            d_head=16,
            d_ff=128,
            vocab_size=256,
            enc_len=32,
            chunk_size=16,
            remat=False,
        )
        if self.attn_kind == "mla":
            kw.update(q_lora_rank=32 if self.q_lora_rank else 0, kv_lora_rank=32,
                      qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, d_head=0)
        if self.is_moe:
            # capacity_factor high enough that tiny-shape tests never drop
            # tokens (drops are legitimate MoE behaviour but break exact
            # decode-vs-forward consistency checks)
            kw.update(n_experts=4, top_k=min(2, self.top_k), d_ff_expert=64,
                      n_shared_experts=min(1, self.n_shared_experts),
                      first_dense_layers=min(1, self.first_dense_layers),
                      capacity_factor=8.0)
        if self.ssm_kind == "rwkv6":  # needs H*K == d_model
            kw.update(ssm_heads=4, ssm_head_dim=16)
        elif self.ssm_kind == "mamba2":  # needs H*P == d_inner
            kw.update(ssm_state=16, ssm_heads=8, ssm_head_dim=16, d_inner=128)
        if self.attn_every:
            kw.update(n_layers=5, attn_every=2, shared_lora_rank=8)
        if self.is_encoder_decoder:
            kw.update(enc_layers=2)
        if self.prefix_len:
            kw.update(prefix_len=8)
        if self.window:
            kw.update(window=32)
        return self.replace(**kw)


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    """Analytic parameter count used for MODEL_FLOPS = 6*N*D."""
    d = cfg.d_model
    n = 0
    # embeddings (counted once; output head excluded from 6ND convention
    # unless tied; we include input embed only in totals, not in "active"
    # matmul params — follow the PaLM convention of counting matmul params)
    per_layer_attn = 0
    hd = cfg.head_dim
    if cfg.attn_kind == "gqa":
        per_layer_attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d
    elif cfg.attn_kind == "mla":
        qd = cfg.qk_nope_dim + cfg.qk_rope_dim
        if cfg.q_lora_rank:
            per_layer_attn += d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads * qd
        else:
            per_layer_attn += d * cfg.n_heads * qd
        per_layer_attn += d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
        per_layer_attn += cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
        per_layer_attn += cfg.n_heads * cfg.v_head_dim * d
    # mlp
    def dense_mlp(dff: int) -> int:
        return 3 * d * dff  # swiglu/geglu: gate+up+down

    n_layers = cfg.n_layers
    if cfg.ssm_kind == "mamba2":
        d_in = cfg.d_inner
        per_ssm = d * (2 * d_in + 2 * cfg.ssm_state + cfg.ssm_heads) + d_in * d + d_in * d  # in/out + norm-ish
        n += n_layers * per_ssm
        if cfg.attn_every:
            n_attn = n_layers // cfg.attn_every
            shared = per_layer_attn + dense_mlp(cfg.d_ff)
            n += shared  # weights shared across invocations
            n += n_attn * 2 * cfg.shared_lora_rank * d * 2
    elif cfg.ssm_kind == "rwkv6":
        per = 4 * d * d + d * d  # r,k,v,g,o projections (d_head-grouped)
        per += dense_mlp(cfg.d_ff) // 3 * 2  # rwkv channel-mix: 2 mats (k,v) + r
        per += d * d // 1  # receptance in channel mix
        n += n_layers * per
    else:
        moe_layers = 0
        if cfg.is_moe:
            moe_layers = n_layers - cfg.first_dense_layers
        dense_layers = n_layers - moe_layers
        n += n_layers * per_layer_attn
        n += dense_layers * dense_mlp(cfg.d_ff)
        if cfg.is_moe:
            e_active = cfg.top_k + cfg.n_shared_experts
            e_count = e_active if active_only else (cfg.n_experts + cfg.n_shared_experts)
            n += moe_layers * e_count * dense_mlp(cfg.d_ff_expert)
            n += moe_layers * d * cfg.n_experts  # router
    if cfg.is_encoder_decoder:
        # decoder layers already counted above; add encoder + cross-attn
        n += cfg.enc_layers * (per_layer_attn + dense_mlp(cfg.d_ff))
        n += cfg.n_layers * per_layer_attn  # cross attention
    if not active_only:
        n += cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return int(n)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def list_configs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    # every configuration of the reference zoo; models/lm.py builds the
    # dense, MoE, sliding-window and VLM kinds (the rest raise until
    # ROADMAP Queue A item 3), the analytic engine reads them all
    from repro_torch.configs import (  # noqa: F401
        qwen3_14b, command_r_35b, qwen2_5_14b, minicpm3_4b, rwkv6_7b,
        mixtral_8x7b, deepseek_v2_236b, zamba2_7b, paligemma_3b,
        whisper_base, siso_embedder,
    )


ARCH_IDS = [
    "qwen3-14b", "command-r-35b", "qwen2.5-14b", "minicpm3-4b", "rwkv6-7b",
    "mixtral-8x7b", "deepseek-v2-236b", "zamba2-7b", "paligemma-3b",
    "whisper-base",
]
