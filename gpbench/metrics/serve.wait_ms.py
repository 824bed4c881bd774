"""serve.wait_ms (ms): the host's waits on the card per served cycle, from
the program's spans: for a staging set's last upload
(gridpp.serve.stage.wait), for the download (gridpp.serve.fetch.wait) and
for a value the cycle reads back (gridpp.cycle.sync)."""

from gpbench.harness.program_trace import ms_per_cycle


def read(ctx):
    return ms_per_cycle({"gridpp.serve.stage.wait",
                         "gridpp.serve.fetch.wait", "gridpp.cycle.sync"})
