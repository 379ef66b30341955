"""Run one benchmark cell once on the card this process sees:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with --trace 1 ``breakdown``, and the compared numbers under ``checks``);
the compared numbers and their limits are also the last lines of standard
error. Exits non-zero, printing no result, without enough CUDA devices or
when a module of JAX or of the JAX package was loaded."""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

from benchlib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t_start=T_START))
