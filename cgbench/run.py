"""Run one cell of the benchmark once, from the root of a checkout:

    python3 cgbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``harness`` says what a run does and prints.  The run's set-up time counts from here,
before anything is imported."""

import time

T_START = time.time()

import pathlib  # noqa: E402
import sys  # noqa: E402

# run as a script, this file's folder leads sys.path; the checkout's root has to
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

if __name__ == "__main__":
    from cgbench import harness

    sys.exit(harness.main(t_start=T_START))
