"""The cycle bound of an ensemble OI configuration (EnsiPipeline), from
what the mathematics needs, not from what the port's code issues.

N = Y * X gridpoints, E = members, S = max_points, P = stations.

Bytes:
    4NE  the members, read once
    4NE  the analysis, written once
    8P   the obs and their sigmas, read once
    8NS  the state a cycle must read: an obs index (int32) and a rho (f32)
         for every gridpoint and slot
    4PE  the members at the obs (the anomalies Y), read once
Operations a gridpoint (the transform, oi_ensi.cpp):
    E S        Y^T R^-1 (R^-1 diagonal)
    2 E^2 S    Pinv = (Y^T R^-1) Y
    E^3        the inverse square root of Pinv, at a nominal E^3
               (`assumed` in the configuration: no particular solver's
               iteration count)
    2 E S      Y^T R^-1 (obs - y_hat)
    2 E^2      w = Pinv^-1 (...)
    2 E^2      W x
    4 E        the members' mean and anomalies, and x . w
With a missing_fraction above 0 the selection reads the whole shortlist of
K = candidates a gridpoint: 8N(K - S) bytes more.
"""
from __future__ import annotations


def cycle(config: dict, traffic: dict):
    n = int(config["grid"]["ny"]) * int(config["grid"]["nx"])
    e = int(config["members"])
    s = int(config["max_points"])
    p = int(config["stations"])
    nbytes = 8 * n * e + 8 * p + 8 * n * s + 4 * p * e
    if float(traffic["missing_fraction"]) > 0:
        nbytes += 8 * n * (int(config["candidates"]) - s)
    ops = n * (e * s + 2 * e * e * s + e ** 3 + 2 * e * s + 4 * e * e
               + 4 * e)
    return nbytes, ops
