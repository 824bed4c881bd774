"""Published peaks by card and the K1 byte rule, frozen here.

PEAKS is a copy of gridpp_tpu_torch/tools/roofline.py's table (NVIDIA's
data sheets, dense, at the card's full power limit): HBM bytes/s and f32
operations/s outside the tensor cores. Matched in order against the name
torch.cuda.get_device_name() gives.

K1 (the neighbourhood mean of a (Y, X) float32 field) must read the field
once and write its mean once: 2 * Y * X * 4 bytes, whatever it re-reads.
"""
from __future__ import annotations

PEAKS = (
    ("H100 NVL", {"bytes": 3.9e12, "f32": 60e12}),
    ("H100 PCIe", {"bytes": 2.0e12, "f32": 51e12}),
    ("H100", {"bytes": 3.35e12, "f32": 67e12}),
)


def peaks(device_name: str):
    """The card's peaks, or None for a card not in the table."""
    for key, p in PEAKS:
        if key in device_name:
            return p
    return None


def k1_bytes(ny: int, nx: int) -> int:
    return 2 * ny * nx * 4


def bound_s(nbytes: float, ops: float, p: dict) -> float:
    """The least time of the work on a card of peaks p: the longer of its
    bytes over the memory rate and its operations over the f32 rate."""
    return max(nbytes / p["bytes"], ops / p["f32"])
