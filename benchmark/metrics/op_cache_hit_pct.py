"""op_cache_hit_pct (%; the operator, program counter): of the traced
window's `snp_randomSVD` calls that looked up their operator
(`_cached_op`), the share that found it built: 100 x `svd.op_cache_hit`
/ (`svd.op_cache_hit` + `svd.op_build`)."""

from benchlib import program


def read(rec):
    prog = program.recorder(rec)
    if prog is None:
        return None
    hits = prog.counters.get("svd.op_cache_hit", 0)
    looked = hits + prog.counters.get("svd.op_build", 0)
    return 100.0 * hits / looked if looked else None
