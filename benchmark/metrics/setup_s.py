"""setup_s (s, host clock): from the start of benchmark/run.py to the
first timed job: imports, the kernels' load from the compile cache, the
inputs made from the seed, the program's set-up that the traffic needs
and the warm-up of the cell's own shapes."""


def read(rec):
    return rec["setup_s"]
