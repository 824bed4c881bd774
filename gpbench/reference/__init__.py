"""The plain reference of the benchmark's configurations.

Plain NumPy and PyTorch, written from gridpp's semantics (oi.cpp,
oi_ensi.cpp, neighbourhood.cpp) and nothing else: it imports neither jax
nor gridpp_tpu nor gridpp_tpu_torch, and takes nothing the program made.
From the inputs the harness hands to both sides (the grid's and the
stations' coordinates, the fields and obs of a cycle) it works out the
neighbourhood mean, the nearest gridpoint of each station, every
gridpoint's top max_points stations by rho, and the analysis, in float64
(gridpp solves in double), or in a lower precision for the control.
"""
import torch


def tf32(x):
    """x rounded to float32, then to TF32: 10 mantissa bits, to nearest.
    The controls round each product's operands so, and sum the product in
    float32, as the tensor cores do; the rounding is explicit, so a
    control reads the same on every device."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)
