"""cycle.rebuilds_per_cycle (rebuilds/cycle): how much Pipeline.rebuilds
(the general path's count of cycles that rebuilt their gain rows) grew
over the traced run's cycles, read once after them."""


def read(ctx):
    c = ctx.counters
    if "rebuilds" not in c or not c.get("cycles"):
        return None
    return c["rebuilds"] / c["cycles"]
