"""cycle.host_syncs_per_cycle (syncs/cycle): the program's count host.sync
(each host read, on a cycle's path, of a value the card computes) per
served cycle."""

from gpbench.harness.program_trace import per_cycle


def read(ctx):
    return per_cycle("host.sync")
