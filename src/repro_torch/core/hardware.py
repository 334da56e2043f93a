"""Hardware descriptions for roofline analysis (a copy of
``repro.core.hardware``'s ``Hardware``, with the port's entries).

``H100_SXM5_80GB`` is the card the port runs on: NVIDIA's data-sheet
peaks for the H100 SXM5 (989 TFLOP/s dense bf16 on the tensor cores,
3.35 TB/s HBM3), at its 700 W board power. ``H100_PAPER`` is the
reference's entry for the paper's card (64 GB HBM2, the DRAM ceiling
the paper measured), kept for the analyses that reproduce the paper's
numbers. There is no TPU entry: the port never runs on one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float          # FLOP/s per chip (matmul dtype of interest)
    hbm_bw: float              # bytes/s per chip
    link_bw: float             # bytes/s per NVLink link
    hbm_bytes: float           # device memory per chip
    vmem_bytes: float = 0.0    # on-chip scratch (SMEM+L2 analogue)
    host_link_bw: float = 0.0  # PCIe-ish, for host-gap modeling
    # roofline ceilings as *plotted by the paper* (Fig. 1 / Table II use the
    # single-precision CUDA-core ceiling for the attention kernels).
    plot_flops_ceiling: float = 0.0
    plot_bw_ceiling: float = 0.0
    # what torch.cuda.get_device_name() reports for this card, and its
    # board power limit (W), where the entry describes a real card
    device_name: str = ""
    power_w: float = 0.0


H100_SXM5_80GB = Hardware(
    name="h100-sxm5-80gb",
    peak_flops=989e12,         # dense bf16, tensor cores (data sheet)
    hbm_bw=3.35e12,            # HBM3 (data sheet)
    link_bw=50e9,              # one NVLink 4 link (18 per card)
    hbm_bytes=80e9,
    vmem_bytes=50 * 2**20,     # L2
    host_link_bw=64e9,         # PCIe 5.0 x16
    device_name="NVIDIA H100 80GB HBM3",
    power_w=700.0,
)

# The paper's H100 (64GB HBM2 variant), as the reference keeps it: hbm_bw
# is the DRAM roofline ceiling the paper reports in Table II (1.63e12
# B/s); peak_flops is the tensor-core bf16 rate (matmuls); plot_* carry
# the paper's Fig. 1 / Table II plotted ceilings.
H100_PAPER = Hardware(
    name="h100-paper",
    peak_flops=9.9e14,
    hbm_bw=1.63e12,
    link_bw=450e9,
    hbm_bytes=64e9,
    vmem_bytes=50 * 2**20,
    plot_flops_ceiling=2.56e13,
    plot_bw_ceiling=1.63e12,
)

HARDWARE: Dict[str, Hardware] = {h.name: h for h in (H100_SXM5_80GB,
                                                     H100_PAPER)}
BY_DEVICE_NAME: Dict[str, Hardware] = {
    h.device_name: h for h in HARDWARE.values() if h.device_name}


def for_device_name(device_name: str) -> Hardware:
    """The entry of the card ``torch.cuda.get_device_name()`` names; an
    unknown card raises (its peaks are not guessed)."""
    hw = BY_DEVICE_NAME.get(device_name)
    if hw is None:
        raise ValueError(
            f"no Hardware entry for the card {device_name!r} (known: "
            f"{sorted(BY_DEVICE_NAME)}); pass hw= explicitly")
    return hw
