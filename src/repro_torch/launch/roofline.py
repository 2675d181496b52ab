"""Roofline terms of a step (port of ``repro/launch/hlo_analysis.py``).

The reference parses the compiled HLO for its collectives
(``collective_stats``) and its op census (``op_census``). Torch has no
HLO: the port's collectives are the sharded step's own plan
(``launch/step_cost.py``), and neither parser has a counterpart here.
What carries over:

* the wire-byte model of one collective, as one function of (op, bytes,
  group size g), the reference's table:

      all-reduce          2 * S * (g-1)/g     (ring RS + AG)
      all-gather          S_out * (g-1)/g
      reduce-scatter      S_out * (g-1)       (input = S_out * g)
      all-to-all          S * (g-1)/g
      collective-permute  S                   (point-to-point)

* ``Roofline`` and ``model_flops``, as they are, with the device's peak
  FLOP/s, HBM bandwidth and inter-device bandwidth as fields. They
  default to one NVIDIA H100 SXM's data-sheet figures: the first two are
  ``serving.engine``'s (989e12 dense bf16 FLOP/s, 3.35e12 B/s), the third
  NVLink 4's 450e9 B/s each way. The reference fixes TPU v5e figures as
  module constants (197e12, 819e9, 50e9); its tests pass them in.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.serving.engine import H100_BF16_FLOPS, H100_HBM_BW

H100_NVLINK_BW = 450e9       # NVLink 4, bytes/s each way per card

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def wire_bytes(op: str, size: float, g: int) -> float:
    """Bytes one device sends for collective ``op`` over a group of ``g``
    with operand (all-gather, reduce-scatter: result) size ``size``."""
    if op == "all-reduce":
        return 2.0 * size * (g - 1) / g
    if op == "all-gather":
        return size * (g - 1) / g
    if op == "reduce-scatter":
        return size * (g - 1)
    if op == "all-to-all":
        return size * (g - 1) / g
    if op == "collective-permute":
        return float(size)
    raise ValueError(f"unknown collective {op!r}; one of {COLLECTIVES}")


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_total: float
    n_devices: int
    peak_memory_bytes: float = 0.0
    # minimum required HBM traffic (params read once + state read once),
    # the ideal floor for memory-bound (decode) cells
    model_bytes_total: float = 0.0
    peak_flops: float = H100_BF16_FLOPS
    hbm_bw: float = H100_HBM_BW
    link_bw: float = H100_NVLINK_BW

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / traced FLOPs (global). >1: the trace counts fewer
        products than 6ND (masked attention pairs, gathers); <1: remat or
        redundant compute."""
        total = self.flops_per_device * self.n_devices
        return self.model_flops_total / total if total else 0.0

    @property
    def t_ideal(self) -> float:
        """Ideal step time: useful flops at peak vs minimum bytes at peak
        HBM, whichever bound is higher."""
        return max(self.model_flops_total / (self.n_devices * self.peak_flops),
                   self.model_bytes_total / (self.n_devices * self.hbm_bw))

    @property
    def roofline_fraction(self) -> float:
        """t_ideal / the modelled step time (1.0 = at the roof)."""
        t_step = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_ideal / t_step if t_step else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "model_flops_total": self.model_flops_total,
            "n_devices": self.n_devices,
            "peak_memory_bytes": self.peak_memory_bytes,
            "model_bytes_total": self.model_bytes_total,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "t_ideal": self.t_ideal,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D for train, 2*N*D for inference forward passes
    (D = processed tokens; N = active matmul params)."""
    n_act = cfg.active_params
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_act * tokens


__all__ = ["COLLECTIVES", "H100_NVLINK_BW", "Roofline", "model_flops",
           "wire_bytes"]
