"""The card's roofline: the port's counterpart of the constants and the
``Roofline`` terms of the JAX package's ``launch/hlo_analysis.py``, without
its HLO parsing (XLA's post-partitioning text has no analog here).

``H100`` is one NVIDIA H100 SXM5 80 GB in a DGX H100 node, every number
from NVIDIA's H100 Tensor Core GPU data sheet (SXM column, dense rates
without sparsity).  ``sync.plan`` reads the peak and the data-parallel
link; ``launch.dryrun`` fills a ``Roofline`` for each traced cell.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float      # dense bf16 tensor-core FLOP/s
    hbm_bw: float          # HBM bytes/s
    hbm_bytes: float       # HBM capacity, bytes
    nvlink_bw: float       # NVLink bytes/s each way, inside a node
    dp_link_bw: float      # bytes/s each way of the link a data-parallel
                           # gradient sync crosses (between nodes)


H100 = Hardware(
    name="NVIDIA H100 SXM5 80GB",
    peak_flops=989e12,     # data sheet: BF16 Tensor Core 1,979 TFLOPS with
                           # sparsity, so 989.5 dense
    hbm_bw=3.35e12,        # data sheet: GPU memory bandwidth 3.35 TB/s
    hbm_bytes=80e9,        # data sheet: GPU memory 80 GB
    nvlink_bw=450e9,       # data sheet: NVLink 900 GB/s, both directions
    dp_link_bw=50e9,       # DGX H100: one ConnectX-7 NDR InfiniBand port of
                           # 400 Gb/s per GPU
)


@dataclasses.dataclass
class Roofline:
    """The three roofline terms of one step on one rank, as the JAX
    package's ``hlo_analysis.Roofline`` has them, on ``hw``: its collective
    term crosses ``hw.dp_link_bw`` where the JAX package's crosses ICI."""
    flops: float                # per-rank flops
    hbm_bytes: float            # per-rank bytes accessed
    coll_bytes: float           # per-rank collective bytes on the wire
    coll_breakdown: dict
    chips: int
    model_flops: float = 0.0    # 6·N·D (global)
    hw: Hardware = H100

    @property
    def compute_s(self) -> float:
        return self.flops / self.hw.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.hw.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / self.hw.dp_link_bw

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
        """model_flops / (flops × chips): what remat and redundancy add."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful compute time over the bound time."""
        if self.bound_s <= 0:
            return 0.0
        useful_s = self.model_flops / (self.chips * self.hw.peak_flops)
        return useful_s / self.bound_s

    def to_dict(self) -> dict:
        """The terms under the JAX package's keys."""
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }
