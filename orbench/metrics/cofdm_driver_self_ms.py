"""Self time of the COFDM receive driver and chain glue a batch: the
batch's time in the traced window less its BP and outer-decode spans
(each synchronised at both edges)."""


def read(run):
    b, lat = run.spans.batches, run.latencies_ms
    if not b or len(b) != len(lat):
        return None
    return sum(t - s.get("ldpc", 0.0) - s.get("outer", 0.0)
               for t, s in zip(lat, b)) / len(b)
