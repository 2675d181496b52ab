"""Sharding rules and placements (port of ``repro/distributed/sharding.py``):
params, optimizer state, activations and caches over a
:class:`~repro_torch.launch.mesh.Mesh` of torch devices.

Mesh axes: ("pod",)? + ("data", "model").
  * TP        — feature dims over "model".
  * FSDP      — train mode also shards the complementary feature dim (and
                the AdamW moments, which reuse the same specs) over "data".
  * EP        — MoE expert dim over "model" when divisible, else the expert
                ffn dim ("2D MoE sharding").
  * DP        — batch over ("pod","data") for activations and caches.

The rules are the reference's, by leaf name. The reference stacks
``blocks`` and ``enc_blocks`` along a leading layer axis and right-aligns
each spec against the leaf's rank; the port keeps a list of layers, so a
layer's leaf is one rank lower. :func:`param_spec` applies the reference's
rule at the reference's rank and drops the stacked axis's leading
``None``, so every spec is the reference's without it (its MoE rule tests
``nd >= 4``: (layers, E, d_in, d_out)).

A placement (:func:`device_put` with a :class:`NamedSharding`) cuts a
tensor into one block per mesh coordinate, on that coordinate's device.
A dim of n elements sharded over k devices gets blocks of ceil(n / k)
elements, the last ones short or empty, as XLA pads a dim that does not
divide; :func:`gather` puts the exact tensor back together. Coordinates
that hold the same block on the same device share one copy, so virtual
devices (a device repeated in the mesh) never hold replicas of a block.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

# param-name -> spec over the LAST dims (right-aligned; rest None)
# "F" marks the fsdp-shardable dim (data axis in train mode, None in serve).
_COL = ("wq", "wk", "wv", "wg", "wr", "w_gate", "w_up", "in_proj", "cm_wk",
        "cm_wr", "wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "lm_head",
        "embed_proj")
_ROW = ("wo", "w_down", "out_proj", "cm_wv")
_REPL = ("scale", "bias", "bq", "bk", "bv", "mu", "mu_x", "cm_mu_k",
         "cm_mu_r", "w0", "wa", "wb", "dd_w1", "dd_w2", "u", "A_log", "D",
         "dt_bias", "conv_b", "router", "lora_a", "lora_b", "tok_embed")

# the collections the reference stacks along a leading layer axis
_STACKED = ("blocks", "enc_blocks")


class PartitionSpec:
    """One entry per tensor dim: a mesh axis name, a tuple of axis names
    (sharded over their product, row-major) or ``None`` (replicated). Not
    a tuple, so tree walks treat it as a leaf; it compares equal to the
    tuple of its entries."""
    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = tuple(parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            other = other._parts
        return isinstance(other, tuple) and self._parts == other

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return "PartitionSpec" + repr(self._parts)


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: PartitionSpec


# ---------------------------------------------------------------------------
# trees of specs
# ---------------------------------------------------------------------------


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any,
                       path: tuple = ()) -> Any:
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts and lists (a
    NamedTuple keeps its type); a path is its dict keys and list indices.
    Specs, shardings and placed tensors are leaves."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      path=path + (k,)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(
            fn, v, *(r[i] for r in rest), path=path + (i,))
            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, *(r[i] for r in rest),
                                   path=path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    return tree_map_with_path(lambda _, x, *r: fn(x, *r), tree, *rest)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _reference_spec(path, nd: int, cfg: ModelConfig, fsdp: bool,
                    expert_data: bool, fsdp_axes: tuple) -> P:
    """The reference's rule for a leaf of rank ``nd`` (its own rank)."""
    name = _leaf_name(path)
    path_str = "/".join(str(e) for e in path)
    F = (fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]) if fsdp else None

    def right(spec_tail: tuple) -> P:
        pad = (None,) * (nd - len(spec_tail))
        return P(*(pad + spec_tail))

    if name == "embed":
        return right(("model", F))
    if "mlp" in path_str and "shared" not in path_str \
            and name in ("w_gate", "w_up", "w_down") \
            and nd >= 4 and cfg.is_moe:
        # MoE expert tensors (E, d_in, d_out)
        if expert_data:
            if name == "w_down":
                return right(("data", "model", None))
            return right(("data", None, "model"))
        if cfg.n_experts % 16 == 0:
            if name == "w_down":
                return right(("model", F, None))
            return right(("model", None, F))
        # small expert count: shard ffn dim over model, fsdp on the other
        if name == "w_down":
            return right((None, "model", F))
        return right((None, F, "model"))
    if name == "conv_w":
        return right((None, "model"))
    if name in _REPL or nd <= 1:
        return P(*([None] * nd))
    if name in _COL:
        return right((F, "model"))
    if name in _ROW:
        return right(("model", F))
    return P(*([None] * nd))


def param_spec(path, leaf, cfg: ModelConfig, fsdp: bool,
               expert_data: bool = False,
               fsdp_axes: tuple = ("data",)) -> P:
    """expert_data: serve-mode 2D MoE sharding — experts over "data",
    expert ffn over "model". fsdp_axes: mesh axes the FSDP dim shards over
    (("pod", "data") on the multi-pod mesh). A leaf of one of ``blocks``'
    or ``enc_blocks``' layers gets the reference's spec of the stacked
    leaf without its leading (layer) entry."""
    stacked = bool(path) and path[0] in _STACKED
    spec = _reference_spec(path, len(leaf.shape) + stacked, cfg, fsdp,
                           expert_data, fsdp_axes)
    if stacked:
        assert spec[0] is None, (path, spec)
        return P(*spec[1:])
    return spec


def param_specs(params, cfg: ModelConfig, fsdp: bool,
                expert_data: bool = False, fsdp_axes: tuple = ("data",)):
    return tree_map_with_path(
        lambda path, leaf: param_spec(path, leaf, cfg, fsdp, expert_data,
                                      fsdp_axes), params)


def opt_state_specs(state, params_specs):
    """AdamW moments reuse the param specs; step is replicated."""
    from repro_torch.training.optimizer import AdamWState
    return AdamWState(P(), params_specs, params_specs)


def _dp_axis(dp):
    if not dp:
        return None
    return dp if len(dp) > 1 else dp[0]


def batch_specs(cfg: ModelConfig, kind: str, dp=("data",)) -> dict:
    dp_ax = _dp_axis(dp)
    spec: dict = {"tokens": P(dp_ax, None)}
    if kind == "train":
        spec["labels"] = P(dp_ax, None)
    if cfg.family == "vlm":
        spec["patch_embed"] = P(dp_ax, None, None)
    if cfg.is_encoder_decoder:
        spec["frames"] = P(dp_ax, None, None)
    return spec


def cache_specs(cfg: ModelConfig, dp=("data",), seq_shard: bool = False,
                seq_axes=None):
    """Decode cache specs. Default: batch over dp, heads over model.
    seq_shard=True: KV sequence over model (flash-decoding SP).
    seq_axes: explicit axes tuple for the KV seq dim (overrides seq_shard),
    e.g. ("data", "model") for long_500k's batch-1 caches."""
    dp_ax = _dp_axis(dp)
    kind_specs = {}
    if seq_axes is not None:
        seq_ax = seq_axes if len(seq_axes) > 1 else seq_axes[0]
        head_ax = None
    else:
        seq_ax = "model" if seq_shard else None
        head_ax = None if seq_shard else "model"
    kind_specs["k"] = kind_specs["v"] = P(None, dp_ax, seq_ax, head_ax, None)
    kind_specs["k_scale"] = kind_specs["v_scale"] = P(None, dp_ax, seq_ax,
                                                      head_ax)
    # cross-attn memory: fixed enc_len (1500), not the decode seq — batch only
    kind_specs["xk"] = kind_specs["xv"] = P(None, dp_ax, None, None, None)
    kind_specs["ak"] = kind_specs["av"] = P(None, dp_ax, seq_ax, head_ax, None)
    kind_specs["latent"] = P(None, dp_ax, seq_ax, None)
    kind_specs["krope"] = P(None, dp_ax, seq_ax, None)
    # ssm states: heads over model
    kind_specs["s"] = P(None, dp_ax, "model", None, None)
    kind_specs["conv"] = P(None, dp_ax, None, "model")
    kind_specs["tm_x"] = P(None, dp_ax, None)
    kind_specs["cm_x"] = P(None, dp_ax, None)
    return kind_specs


def cache_spec_tree(cache, cfg: ModelConfig, dp=("data",),
                    seq_shard: bool = False, seq_axes=None):
    table = cache_specs(cfg, dp, seq_shard, seq_axes)
    return {k: table[k] for k in cache}


def named(mesh, tree_specs):
    return tree_map(lambda s: NamedSharding(mesh, s), tree_specs)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------


def _dim_axes(spec: P, ndim: int) -> list:
    """Each dim's mesh axes (a tuple, empty where replicated)."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than rank {ndim}")
    out = []
    for i in range(ndim):
        ax = spec[i] if i < len(spec) else None
        out.append(() if ax is None else ax if isinstance(ax, tuple)
                   else (ax,))
    return out


def block_slices(shape, mesh, spec: P, coord: dict) -> tuple:
    """The slices of the block at mesh coordinate ``coord`` (axis name ->
    index): along a dim sharded k ways, block i covers [i c, (i + 1) c)
    clipped to the dim, c = ceil(n / k)."""
    sizes = mesh.shape
    out = []
    for n, axes in zip(shape, _dim_axes(spec, len(shape))):
        k, i = 1, 0
        for a in axes:
            k, i = k * sizes[a], i * sizes[a] + coord[a]
        c = -(-n // k)
        lo = min(i * c, n)
        out.append(slice(lo, min(lo + c, n)))
    return tuple(out)


def _coords(mesh):
    """(axis name -> index, device) for every mesh coordinate, row-major."""
    for idx in np.ndindex(mesh.devices.shape):
        yield dict(zip(mesh.axis_names, idx)), mesh.devices[idx]


def _key(dev: torch.device, sl: tuple) -> tuple:
    return (dev, tuple((s.start, s.stop) for s in sl))


class Placed:
    """A tensor placed on a mesh: one block per mesh coordinate, on that
    coordinate's device, each distinct (device, block) held once."""

    def __init__(self, sharding: NamedSharding, shape, dtype,
                 blocks: dict):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.blocks = blocks          # (device, slices) -> tensor

    def keys(self):
        """(mesh coordinate, block key) for every coordinate."""
        sh = self.sharding
        for coord, dev in _coords(sh.mesh):
            yield coord, _key(dev, block_slices(self.shape, sh.mesh,
                                                sh.spec, coord))

    def block(self, **coord) -> torch.Tensor:
        """The block at the named coordinates (0 on axes not named)."""
        mesh = self.sharding.mesh
        c = {a: coord.get(a, 0) for a in mesh.axis_names}
        dev = mesh.devices[tuple(c[a] for a in mesh.axis_names)]
        return self.blocks[_key(dev, block_slices(
            self.shape, mesh, self.sharding.spec, c))]

    def map_blocks(self, fn: Callable) -> "Placed":
        """A placement of the same spec with ``fn`` applied to each block."""
        blocks = {k: fn(b) for k, b in self.blocks.items()}
        b0 = next(iter(blocks.values()))
        return Placed(self.sharding, self.shape, b0.dtype, blocks)

    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.blocks.values())

    def __repr__(self) -> str:
        return (f"Placed({tuple(self.shape)}, {self.dtype}, "
                f"{self.sharding.spec}, {len(self.blocks)} blocks)")


def device_put(x: torch.Tensor, sharding: NamedSharding) -> Placed:
    """Place ``x`` on ``sharding.mesh`` by ``sharding.spec``: each block a
    copy of its slice of ``x`` on its device (never a view of ``x``)."""
    blocks: dict = {}
    for coord, dev in _coords(sharding.mesh):
        sl = block_slices(x.shape, sharding.mesh, sharding.spec, coord)
        k = _key(dev, sl)
        if k not in blocks:
            blocks[k] = x[sl].to(dev, copy=True).contiguous()
    return Placed(sharding, x.shape, x.dtype, blocks)


def zeros_placed(like: Placed, dtype=None) -> Placed:
    """Zeros placed as ``like``, in ``dtype`` (default like's)."""
    blocks = {k: torch.zeros(b.shape, dtype=dtype or b.dtype,
                             device=b.device)
              for k, b in like.blocks.items()}
    return Placed(like.sharding, like.shape, dtype or like.dtype, blocks)


def gather(x: Placed, device=None) -> torch.Tensor:
    """The whole tensor on ``device`` (default: the mesh's first device),
    assembled from one copy of each block: the exact tensor placed. Where
    one block on ``device`` holds it all, that block itself."""
    dev = torch.device(device) if device is not None else \
        x.sharding.mesh.devices.flat[0]
    whole = _key(dev, tuple(slice(0, n) for n in x.shape))
    if whole in x.blocks:           # one block holds it all, on ``dev``
        return x.blocks[whole]
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    done = set()
    for (_, sl), b in x.blocks.items():
        if sl not in done:
            done.add(sl)
            out[tuple(slice(lo, hi) for lo, hi in sl)] = b.to(dev)
    return out


def place_tree(tree: Any, shardings: Any) -> Any:
    """``device_put`` leaf by leaf (``shardings`` a tree like ``tree``)."""
    return tree_map(device_put, tree, shardings)


def gather_tree(tree: Any, device=None) -> Any:
    return tree_map(lambda x: gather(x, device) if isinstance(x, Placed)
                    else x, tree)


__all__ = ["NamedSharding", "P", "PartitionSpec", "Placed", "batch_specs",
           "block_slices", "cache_spec_tree", "cache_specs", "device_put",
           "gather", "gather_tree", "named", "opt_state_specs",
           "param_spec", "param_specs", "place_tree", "tree_map",
           "tree_map_with_path", "zeros_placed"]
