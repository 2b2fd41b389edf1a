"""auto_sweep_roofline_pct (%; kernels, the LDpred2-auto sweep, device
trace): the least time of the window's LDpred2-auto sweeps over the device
time of `gibbs_ring_kernel` (csrc/gibbs_sweep.cu) in the profiler. The
least time of a sweep is `roofline.gibbs_sweep` at the job's shapes (the
job kind's `shapes()["sweep"]`: the in-block LD entries, the variants, the
chains, and the words a variant and a chain and variant the auto sweep
consumes), at 3.35 TB/s or its per-row step at 67 TFLOP/s."""

from benchlib import roofline

KERNEL = "gibbs_ring_kernel"


def read(rec):
    tr, sw = rec["trace"], rec["shapes"].get("sweep")
    if tr is None or sw is None:
        return None
    launches = rec["counters"].get("sweep", 0)
    dev_s = tr.kernel_s(KERNEL)
    if launches <= 0 or dev_s <= 0:
        return None
    least, by = roofline.gibbs_sweep(**sw)
    rec["log"](f"auto_sweep_roofline_pct: {launches} sweeps x "
               f"{least * 1e3:.4f} ms ({by} bound) over {dev_s * 1e3:.3f} ms "
               f"in {tr.kernel_n(KERNEL)} {KERNEL} launches")
    return 100.0 * launches * least / dev_s
