"""Run one cell of the benchmark of bigsnpr_tpu_torch on this machine's
CUDA device(s):

    python3 benchmark/run.py --workload pca_ukbb.randomsvd --seed 7 \
        --seconds 45 --trace 0

from the root of a checkout. Prints the result line (JSON) as the last
line of standard output, and the numbers that decided `correct`, each
beside its limit, as the last lines of standard error. Exits non-zero,
with no result line, without enough CUDA devices, when the run fails, or
when JAX or the JAX package was loaded. See benchmark/README.md.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here

import sys                                          # noqa: E402
from pathlib import Path                            # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchlib import harness                        # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
