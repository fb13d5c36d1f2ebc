"""Host time a batch in the outer decoder (``chain.outer_decode_batch``,
synchronised at both edges), from the traced window."""


def read(run):
    return run.spans.mean("outer")
