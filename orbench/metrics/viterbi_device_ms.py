"""Device time of the Viterbi kernels a batch, from the profiled window."""


def viterbi_seconds(profile):
    return sum(v for k, v in profile.by_kernel.items() if "viterbi" in k)


def read(run):
    p = run.profile
    if p is None:
        return None
    s = viterbi_seconds(p)
    return s / p.batches * 1e3 if s > 0 else None
