"""auto_driver_device_ms (ms; the Krylov and sampler drivers, device
trace): the device's busy time over the traced window less the device
time of the sweep kernel (`gibbs_ring_kernel`) and of the genotype
products (`plane_wgmma_kernel`, the scores), over the window's sweep
launches: the device time of LDpred2-auto's driver a sweep, the MLE's
profile, the draws, the sums and the update."""

KERNELS = ("gibbs_ring_kernel", "plane_wgmma_kernel")


def read(rec):
    tr = rec["trace"]
    launches = rec["counters"].get("sweep", 0)
    if tr is None or launches <= 0 or tr.summary["device_events"] == 0:
        return None
    if tr.kernel_s(KERNELS[0]) <= 0:
        return None
    rest = tr.summary["busy_s"] - sum(tr.kernel_s(k) for k in KERNELS)
    return 1e3 * rest / launches
