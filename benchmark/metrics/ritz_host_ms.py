"""ritz_host_ms (ms; the Krylov driver, program span): the self time of
the program's `svd.ritz` spans over their count: a Krylov depth's Ritz
step on the host (the Gram corner's `eigvalsh` in float64 and the
convergence test), its `host.read` child, the corner's copy, left out."""

from benchlib import program


def read(rec):
    prog = program.recorder(rec)
    if prog is None or prog.n("svd.ritz") == 0:
        return None
    return prog.self_ms("svd.ritz") / prog.n("svd.ritz")
