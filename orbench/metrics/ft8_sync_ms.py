"""Device time a batch of the FT8 sync (waterfall, Costas grid, top-k,
LLR gather: ``ft8_sync._sync_batch_llrs``), by CUDA events around the
call, from the traced window."""


def read(run):
    return run.spans.mean("sync")
