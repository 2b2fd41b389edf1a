"""geno_launches_per_job (launches; operator layer, program counter): the
change in ops/geno_kernels.launches of K1 ("cprod") and K2 ("prod") over
the traced window, over its jobs: 2 x the Krylov depth + 2 in a
randomized SVD."""


def read(rec):
    c = rec["counters"]
    n = c.get("cprod", 0) + c.get("prod", 0)
    return n / rec["jobs"] if n and rec["jobs"] else None
