"""The card's roofline constants: the port's counterpart of the constants
at the top of the JAX package's ``launch/hlo_analysis.py``, without its HLO
parsing (XLA's post-partitioning text has no analog here).

``H100`` is one NVIDIA H100 SXM5 80 GB in a DGX H100 node, every number
from NVIDIA's H100 Tensor Core GPU data sheet (SXM column, dense rates
without sparsity).  ``sync.plan`` reads the peak and the data-parallel
link; the dry-run analog will add its roofline terms here.
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
