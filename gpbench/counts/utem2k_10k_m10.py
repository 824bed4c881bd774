"""The cycle bound of the utem configuration (MultiEnsiPipeline,
variant "utem"), from what the mathematics needs, not from what the port's
code issues.

N = Y * X gridpoints, E = members (background_corr's too), S = max_points,
P = stations.

Bytes:
    4NE  the background, read once
    4NE  background_corr, read once
    4NE  the analysis, written once
    4N   bratios, read once
    8NS  the state a cycle must read: an obs index (int32) and a rho (f32)
         for every gridpoint and slot
    8P   the obs and their pratios, read once
    8PE  the two ensembles at the obs (y_hat and Zc), read once
Operations a gridpoint (oi_ensi_multi.cpp:862-1311):
    E S        Zc^T R^-1 (R^-1 diagonal)
    2 E^2 S    Pinv = (Zc^T R^-1) Zc
    E^3        the inverse square root of Pinv, at a nominal E^3
               (`assumed` in the configuration: no particular solver's
               iteration count)
    2 E S      Zc^T R^-1 (obs - y_hat)
    2 E^2      w = Pinv^-1 (...)
    2 E^2      W^T xc
    10 E       the means, the stds and the normalisation of both
               ensembles, and xc . w
With a missing_fraction above 0 the selection reads the whole shortlist of
K = candidates a gridpoint: 8N(K - S) bytes more.
"""
from __future__ import annotations


def cycle(config: dict, traffic: dict):
    n = int(config["grid"]["ny"]) * int(config["grid"]["nx"])
    e = int(config["members"])
    s = int(config["max_points"])
    p = int(config["stations"])
    nbytes = 12 * n * e + 4 * n + 8 * n * s + 8 * p + 8 * p * e
    if float(traffic["missing_fraction"]) > 0:
        nbytes += 8 * n * (int(config["candidates"]) - s)
    ops = n * (e * s + 2 * e * e * s + e ** 3 + 2 * e * s + 4 * e * e
               + 10 * e)
    return nbytes, ops
