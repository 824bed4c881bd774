"""serve.check_ms (ms): the program's span gridpp.serve.check per served
cycle: the host's finiteness check of a cycle's fresh arrays."""

from gpbench.harness.program_trace import ms_per_cycle


def read(ctx):
    return ms_per_cycle({"gridpp.serve.check"})
