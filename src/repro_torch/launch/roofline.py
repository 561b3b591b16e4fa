"""Roofline terms of one step (port of ``repro.launch.roofline``).

Hardware model: the NVIDIA H100 80GB HBM3 (SXM5) at 700 W, from its data
sheet: 989.4 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM,
and 450 GB/s of NVLink 4 in one direction per card.

  compute term    = flops_per_device / PEAK_FLOPS
  memory term     = hbm_bytes_per_device / HBM_BW
  collective term = collective_bytes_per_device / LINK_BW

The counts come from :mod:`repro_torch.launch.op_analysis` run over one
rank's step (a real one, or on fake tensors in a fake world: the dry
run). Collective bytes follow the ring model (:func:`moved_bytes`, bytes
one device moves):

    all-gather          out_bytes * (n-1)/n
    all-reduce          2 * bytes * (n-1)/n
    reduce-scatter      out_bytes * (n-1)         (out is the scattered shard)
    all-to-all          bytes * (n-1)/n
    collective-permute  bytes

A 256- or 512-card mesh spans many nodes, whose links between nodes are
slower than NVLink, so the collective term over the one-card NVLink rate
is a floor, as the reference's single ICI link figure is. The naive
operand-byte sum is reported beside it (``collective_bytes_naive``).
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989.4e12     # dense bf16 / card (H100 SXM5, 700 W)
HBM_BW = 3.35e12          # bytes/s / card
LINK_BW = 450e9           # bytes/s / card, NVLink 4, one direction

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def moved_bytes(kind: str, nbytes: float, n: int) -> float:
    """Bytes one device moves for a collective ``kind`` whose result has
    ``nbytes`` over a group of ``n`` (the ring model)."""
    n = max(int(n), 1)
    if kind == "all-gather":
        return nbytes * (n - 1) / n
    if kind == "all-reduce":
        return 2 * nbytes * (n - 1) / n
    if kind == "reduce-scatter":
        return nbytes * (n - 1)
    if kind == "all-to-all":
        return nbytes * (n - 1) / n
    if kind == "collective-permute":
        return nbytes
    raise ValueError(f"unknown collective {kind!r}; known: {COLLECTIVES}")


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    hlo_flops: float            # per device
    hlo_bytes: float            # per device
    collective_bytes: float     # per device, ring model
    collective_bytes_naive: float
    model_flops: float          # analytic 6ND (global, per step)
    memory_per_device: dict
    per_op: dict

    @property
    def t_compute(self):
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self):
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self):
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self):
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def useful_flops_ratio(self):
        tot = self.hlo_flops * self.n_devices
        return self.model_flops / tot if tot else 0.0

    @property
    def roofline_fraction(self):
        """Fraction of the dominant-term-bound step time that is useful
        compute: (model_flops / cards / peak) / max(term)."""
        ideal = self.model_flops / self.n_devices / PEAK_FLOPS
        t = max(self.t_compute, self.t_memory, self.t_collective)
        return ideal / t if t else 0.0

    def to_dict(self):
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def active_params(cfg) -> int:
    """Analytic ACTIVE parameter count (MoE: experts_per_token + shared)."""
    if cfg.n_experts == 0:
        return cfg.param_count()
    full = cfg.param_count()
    D, F = cfg.d_model, cfg.d_ff
    n_moe_blocks = sum(1 for b in cfg.pattern if b.ff == "moe") * cfg.n_groups
    inactive = (cfg.n_experts - cfg.experts_per_token) * 3 * D * F * n_moe_blocks
    return full - inactive


def model_flops(cfg, shape_name: str, seq: int, gbatch: int, kind: str) -> float:
    n = active_params(cfg)
    if kind == "train":
        return 6.0 * n * (seq * gbatch)
    if kind == "prefill":
        return 2.0 * n * (seq * gbatch)
    return 2.0 * n * gbatch  # decode: one token per sequence


def analyze(counts: dict, *, arch, shape, mesh_name, n_devices, cfg, seq,
            gbatch, kind) -> Roofline:
    """The terms of one rank's step from :func:`op_analysis.analyze`'s
    result ``counts`` (``flops``, ``hbm_bytes``, ``ring_bytes``,
    ``naive_bytes``, ``per_op`` and the memory keys)."""
    memd = {k: counts[k] for k in ("argument_size_in_bytes",
                                   "output_size_in_bytes",
                                   "temp_size_in_bytes") if k in counts}
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        hlo_flops=float(counts["flops"]),
        hlo_bytes=float(counts["hbm_bytes"]),
        collective_bytes=float(counts["ring_bytes"]),
        collective_bytes_naive=float(counts["naive_bytes"]),
        model_flops=model_flops(cfg, shape, seq, gbatch, kind),
        memory_per_device=memd,
        per_op=counts["per_op"],
    )
