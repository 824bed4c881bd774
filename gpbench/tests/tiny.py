"""Cells of the benchmark's configurations cut to a CPU test's size: a
256 x 256 grid (the Pipeline's tiled path starts at 65,536 gridpoints)
with 400 stations, and the configurations' own structure, selection and
smoothing."""
from __future__ import annotations

import copy

from gpbench.harness import manifest

SIZE = {"grid": {"ny": 256, "nx": 256, "lat": [55.0, 56.0],
                 "lon": [5.0, 6.5]}, "stations": 400}


def cell(name: str, **check) -> manifest.Cell:
    """The named cell with its configuration cut to SIZE (and the check
    given) and its limits as committed."""
    c = manifest.load(name)
    c.config = copy.deepcopy(c.config)
    c.config.update(copy.deepcopy(SIZE))
    if c.config.get("members"):
        c.config["members"] = 4
    c.check = dict(c.check, check_cycles=check.get("check_cycles", 2))
    return c
