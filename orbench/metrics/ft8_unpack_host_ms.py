"""Host time a batch in the FT8 message layer: the ``unpack77`` calls of
``ft8_decode_windows`` summed, from the traced window."""


def read(run):
    return run.spans.mean("unpack")
