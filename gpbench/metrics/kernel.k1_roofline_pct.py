"""kernel.k1_roofline_pct (%): K1's bound (counts/peaks.k1_bytes over the
card's memory rate) over K1's mean device time in the recorded step. K1 is
csrc/neighbourhood_mean.cu's launch of the strip kernel in its sums mode
(`strip_kernel<...0>`)."""

from gpbench.counts import peaks


def _is_k1(name: str) -> bool:
    return "strip_kernel" in name and (")0>" in name or "kSums" in name)


def read(ctx):
    t, p = ctx.trace, ctx.peaks
    k1 = [b - a for name, a, b in t.kernels if _is_k1(name)]
    if not k1 or p is None:
        return None
    g = ctx.config["grid"]
    bound_us = peaks.k1_bytes(int(g["ny"]), int(g["nx"])) / p["bytes"] * 1e6
    return 100.0 * bound_us / (sum(k1) / len(k1))
