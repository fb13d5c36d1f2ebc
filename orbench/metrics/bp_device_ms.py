"""Device time of the LDPC BP kernel a batch, from the profiled window."""


def bp_seconds(profile):
    return sum(v for k, v in profile.by_kernel.items() if "ldpc_bp" in k)


def read(run):
    p = run.profile
    if p is None:
        return None
    s = bp_seconds(p)
    return s / p.batches * 1e3 if s > 0 else None
