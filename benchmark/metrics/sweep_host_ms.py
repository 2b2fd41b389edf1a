"""sweep_host_ms (ms; the sampler driver, host clock and device trace):
the host time of the window's LDpred2 calls over their sweep launches
(the change in ops/gibbs_kernels.launches["sweep"]), less the mean device
time of one `gibbs_ring_kernel` launch: the sampler's own host and torch
work a sweep."""

KERNEL = "gibbs_ring_kernel"


def read(rec):
    tr = rec["trace"]
    launches = rec["counters"].get("sweep", 0)
    call_s = rec["spans"].get("ldpred2", 0.0)
    if tr is None or launches <= 0 or call_s <= 0:
        return None
    dev_s = tr.kernel_s(KERNEL)
    if dev_s <= 0:
        return None
    return 1e3 * (call_s - dev_s) / launches
