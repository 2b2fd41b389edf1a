"""sweep_roofline_pct (%; kernels, the sweep, device trace): the least
time of the window's Gibbs sweeps over the device time of
`gibbs_ring_kernel` (csrc/gibbs_sweep.cu) in the profiler. The least
time of a sweep is `roofline.gibbs_sweep` at the cell's LD and chain
count: the in-block LD once, the per-variant inputs once, and per chain
and variant the beta read and written and the outputs the sampler
consumes, at 3.35 TB/s; or its per-row step at 67 TFLOP/s."""

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
    rec["log"](f"sweep_roofline_pct: {launches} sweeps x "
               f"{least * 1e3:.4f} ms ({by} bound) over {dev_s * 1e3:.3f} ms "
               f"in {tr.kernel_n(KERNEL)} {KERNEL} launches")
    return 100.0 * launches * least / dev_s
