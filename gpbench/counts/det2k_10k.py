"""The cycle bound of a deterministic OI configuration (Pipeline), from
what the mathematics needs, not from what the port's code issues.

N = Y * X gridpoints, S = max_points, K = candidates, P = stations.

Bytes of a cycle whose gain rows stand (every obs valid):
    4N   the background, read once
    4N   the analysis, written once
    8P   the obs and their ratios, read once
    8NS  the state a cycle must read: a gain weight (f32) and an obs index
         (int32) for every gridpoint and slot
Operations: 2NS, a multiply and an add a slot (the increment); the
smoothing's adds are not counted (it is bytes-bound, as the whole cycle).

With a missing_fraction above 0 the valid set changes every cycle, so the
cycle must also rebuild its gain rows once:
    8NK  bytes: the shortlist's candidates (obs index and rho) read once
    8NS  bytes: the gain rows (weight and index) written once
    N * (11 S (S - 1) / 2 + S^3 / 3 + 2 S^2) operations: the structure
         function of each pair of selected obs (a squared chord distance,
         8 operations, then the scale, the factor -1/2 and the exp, 3),
         one Cholesky factorisation of the S x S matrix (S^3 / 3) and its
         two triangular solves (2 S^2). No sort and no iteration of any
         particular solver is counted.
"""
from __future__ import annotations


def cycle(config: dict, traffic: dict):
    n = int(config["grid"]["ny"]) * int(config["grid"]["nx"])
    s = int(config["max_points"])
    k = int(config["candidates"])
    p = int(config["stations"])
    nbytes = 4 * n + 4 * n + 8 * p + 8 * n * s
    ops = 2 * n * s
    if float(traffic["missing_fraction"]) > 0:
        nbytes += 8 * n * k + 8 * n * s
        ops += n * (11 * s * (s - 1) // 2 + s ** 3 / 3 + 2 * s * s)
    return nbytes, ops
