"""Time each stencil kernel's two routes on one CUDA card, halfwidth by
halfwidth: the one-block ("fused") kernel and the two-launch wide route
(gridpp_tpu_torch/csrc/neighbourhood_wide.cu).

    python3 tools/torch_route_sweep.py [--halfwidths H,H,...] [--reps N]
                                       [--kernels K,K,...]

For K1 (Mean), K2 (Max) and K3 (Std) on a 2000 x 2000 field, and K5 (Mean)
on 2000 x 2000 x 10 members, it forces each route in turn through
ops.stencil's wrappers (stencil_plan replaced for the run), checks the two
against each other (K1/K5 rtol 1e-5, atol 1e-4; K2 equal; K3 rtol 2e-5,
atol 2e-3), and prints the mean time of a few calls by CUDA events and, in
brackets, their device time alone (torch.profiler's CUPTI trace), where
the fused kernel's tile fits a block (K5's: every member in one block),
beside the route the package's plan picks. K4 has only the wide route.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gridpp_tpu_torch.ops import stencil  # noqa: E402

STATS = {"K1": 0, "K2": 30, "K3": 50, "K5": 0}
TOLS = {"K1": (1e-5, 1e-4), "K2": None, "K3": (2e-5, 2e-3),
        "K5": (1e-5, 1e-4)}


def fused_plan(kernel, shape, hy, hx, stat, sms):
    """The one-block plan, or None where its tile does not fit."""
    if kernel in stencil.STRIP_PLANES:
        return stencil._strip_fit(shape[0] if len(shape) == 3 else 1,
                                  shape[-2], shape[-1], hy, hx,
                                  stencil.STRIP_PLANES[kernel], sms)
    return stencil._member_fit(shape[1], shape[2], hy, hx, stat)


def device_ms(fn, reps):
    """Mean device (kernel) time of fn() over reps calls from
    torch.profiler's CUPTI trace, host overhead excluded (NaN where the
    trace shows none)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / reps / 1e3 if total else float("nan")


def forcing(route):
    """A stencil_plan that takes `route`."""
    def plan(kernel, shape, hy, hx, stat=None, t=0, sms=stencil.H100_SMS):
        if route == "wide":
            return stencil.StencilPlan(
                "wide", None, stencil.wide_scratch(kernel, shape, stat))
        return stencil.StencilPlan(
            "fused", fused_plan(kernel, shape, hy, hx, stat, sms), ())
    return plan


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--halfwidths",
                    default="7,10,11,12,15,20,30,32,35,40,60,80")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernels", default="K1,K2,K3,K5")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_route_sweep: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    bg = torch.as_tensor(rng.normal(280, 5, (2000, 2000)).astype(np.float32),
                         device=dev)
    anom = bg - 280.0
    ens = torch.as_tensor(rng.normal(280, 5, (2000, 2000, 10)).astype(
        np.float32), device=dev)
    calls = {
        "K1": (bg.shape, lambda h: stencil.neighbourhood_mean_cuda(
            bg, h, h, 0)),
        "K2": (bg.shape, lambda h: stencil.neighbourhood_minmax_cuda(
            bg, h, h, 30)),
        "K3": (bg.shape, lambda h: stencil.neighbourhood_var_cuda(
            anom, h, h, 50)),
        "K5": (ens.shape, lambda h: stencil.neighbourhood_members_cuda(
            ens, h, h, 0)),
    }
    package_plan = stencil.stencil_plan
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sms = stencil._device_sms(dev)
    try:
        for kernel in args.kernels.split(","):
            shape, call = calls[kernel]
            for h in (int(v) for v in args.halfwidths.split(",")):
                picked = package_plan(kernel, shape, h, h, STATS[kernel],
                                      sms=sms).route
                times, outs = {}, {}
                for route in ("fused", "wide"):
                    if route == "fused" and fused_plan(
                            kernel, shape, h, h, STATS[kernel],
                            sms) is None:
                        continue
                    stencil.stencil_plan = forcing(route)
                    outs[route] = call(h)
                    for _ in range(2):  # warm up the route and the clocks
                        call(h)
                    torch.cuda.synchronize()
                    start.record()
                    for _ in range(args.reps):
                        call(h)
                    end.record()
                    torch.cuda.synchronize()
                    times[route] = (start.elapsed_time(end) / args.reps,
                                    device_ms(lambda: call(h), args.reps))
                    stencil.stencil_plan = package_plan
                agree = "fused route does not fit"
                if "fused" in outs:
                    tol = TOLS[kernel]
                    a, b = outs["fused"], outs["wide"]
                    agree = ("agree" if (torch.equal(a, b) if tol is None
                                         else torch.allclose(
                                             a, b, rtol=tol[0], atol=tol[1],
                                             equal_nan=True))
                             else "DISAGREE")
                print(f"  {kernel} h={h}: " + ", ".join(
                    f"{r} {ms:.4f} ms ({dms:.4f})"
                    for r, (ms, dms) in times.items())
                    + f" ({agree}; the plan picks {picked})", flush=True)
    finally:
        stencil.stencil_plan = package_plan


if __name__ == "__main__":
    main()
