"""Three-term roofline model for the NVIDIA H100 SXM5.

Port of ``repro.utils.roofline`` with the card's constants::

    compute    = FLOPs_per_device            / peak bf16 FLOP/s
    memory     = bytes_per_device            / HBM bytes/s
    collective = collective_bytes_per_device / NVLink bytes/s

Constants, per card, from NVIDIA's H100 SXM5 data sheet (dense rates at
the full 700 W; ``nvidia-smi`` names the card "NVIDIA H100 80GB HBM3"
with a 700 W power limit): 989.4e12 bf16 FLOP/s on the tensor cores,
3.35e12 B/s of HBM3 (``core.partition.H100``'s bandwidth) and 450e9 B/s
of NVLink 4 per card per direction.  A card set below 700 W runs
slower than these figures.

Every input is a per-device quantity of one step, as the dry-run counts
it (each rank's local shards).  A 256-card mesh spans 32 nodes of 8
cards: between nodes the collectives ride InfiniBand (NDR, 50 GB/s per
card), 9x slower than NVLink, so the collective term here is a lower
bound for any collective that crosses a node.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.partition import H100

#: card and power limit the constants assume, as ``nvidia-smi`` gives them
CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS = 989.4e12              # bf16 dense FLOP/s per card
HBM_BW = H100.mem_bw_bytes_per_s   # 3.35e12 bytes/s per card
NVLINK_BW = 450e9                  # bytes/s per card per direction


@dataclass(frozen=True)
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_accessed: float
    collective_bytes: float
    chips: int
    model_flops: float = 0.0     # 6*N*D (dense) / 6*N_active*D (MoE)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs over every card: remat and
        redundancy waste."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def row(self):
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "collective_bytes_per_device": self.collective_bytes,
            "chips": self.chips, "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def roofline(flops_per_device: float, bytes_per_device: float,
             collective_bytes_per_device: float, chips: int,
             model_flops: float = 0.0) -> Roofline:
    """All inputs are per-device quantities of one executed step."""
    return Roofline(
        compute_s=flops_per_device / PEAK_FLOPS,
        memory_s=bytes_per_device / HBM_BW,
        collective_s=collective_bytes_per_device / NVLINK_BW,
        flops=flops_per_device,
        bytes_accessed=bytes_per_device,
        collective_bytes=collective_bytes_per_device,
        chips=chips,
        model_flops=model_flops,
    )


def model_flops_estimate(cfg, shape) -> float:
    """6·N·D with N = active params, D = tokens processed by the step."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens           # forward only
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
