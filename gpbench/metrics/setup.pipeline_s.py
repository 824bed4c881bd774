"""setup.pipeline_s (s): the program's constructor (Pipeline or
EnsiPipeline.__init__: the canonical shortlist on the host, the tile
tables, the static weights), timed by the host clock from the call to a
synchronised device after it."""


def read(ctx):
    return ctx.setup.get("pipeline_s")
