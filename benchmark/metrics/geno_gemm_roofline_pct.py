"""geno_gemm_roofline_pct (%; kernels K1 / K2, device trace): the least
time of the window's K1 and K2 launches over their device time, the
kernel `plane_wgmma_kernel` (csrc/geno_split.cu) in the profiler. The
least time of a launch is `roofline.geno_product` at the call's n, m
and l: the algorithm's 2 n m l operations at 1,979 TOP/s, or the pack
and the float32 operand and result at 3.35 TB/s, the larger."""

from benchlib import roofline

KERNEL = "plane_wgmma_kernel"


def read(rec):
    tr, g = rec["trace"], rec["shapes"].get("geno")
    if tr is None or g is None:
        return None
    launches = rec["counters"].get("cprod", 0) + rec["counters"].get("prod", 0)
    dev_s = tr.kernel_s(KERNEL)
    if launches <= 0 or dev_s <= 0:
        return None
    least, by = roofline.geno_product(g["n"], g["m"], g["l"])
    rec["log"](f"geno_gemm_roofline_pct: {launches} launches x "
               f"{least * 1e3:.4f} ms ({by} bound) over {dev_s * 1e3:.3f} ms "
               f"in {tr.kernel_n(KERNEL)} {KERNEL} launches")
    return 100.0 * launches * least / dev_s
