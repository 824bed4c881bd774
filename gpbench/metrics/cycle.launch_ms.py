"""cycle.launch_ms (ms): the self time of the program's span gridpp.cycle
(run_device: the path's choice and the graph replay's launch or the eager
cycle's enqueue, without its host syncs and graph captures) per served
cycle."""

from gpbench.harness.program_trace import self_ms_per_cycle


def read(ctx):
    return self_ms_per_cycle("gridpp.cycle")
