"""scaling_ms (ms; the entry, program span): the time of the program's
`svd.scaling` spans over the traced window's jobs: `snp_randomSVD`'s
scaling call, `bed_scaleBinom` -> `snp_counts`'s decode on the device
and the host read and float64 work that end it."""

from benchlib import program


def read(rec):
    prog = program.recorder(rec)
    if prog is None or prog.n("svd.scaling") == 0:
        return None
    return program.per_job(rec, prog.total_ms("svd.scaling"))
