"""mle_exps_per_sweep (exps; the Krylov and sampler drivers, program
counter): the exponentials LDpred2-auto's MLE profile evaluated over the
traced window (the program's `auto.mle_exps` counter: chains x profile
points x variants, summed over its calls), over the window's sweep
launches. None where the program keeps no such counter."""

from benchlib import program


def read(rec):
    prog = program.recorder(rec)
    launches = rec["counters"].get("sweep", 0)
    if prog is None or launches <= 0:
        return None
    n = prog.counters.get("auto.mle_exps", 0)
    return n / launches if n else None
