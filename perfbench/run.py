"""The benchmark of ``sonar_tpu_torch`` on NVIDIA GPUs.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

runs one cell of ``BENCHMARK.json`` (a configuration under a traffic mix)
from the root of a checkout and prints one JSON object as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``, then ``checks``: each number compared
with the plain reference beside its limit (also the last lines of standard
error). Without a CUDA device, or with fewer than the cell asks for, it
exits with code 3 and prints no result.

Two options are not for measured runs: ``--control`` puts the cell's
control in the program's place (the lower precision whose readings set the
upper end of each limit, ``PERF.md``); ``--fault NAME`` plants one of
``perfbench/harness/faults.py``'s faults in the program, which ``correct``
has to catch.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
from pathlib import Path  # noqa: E402
import sys  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", help="a fault planted in the program (perfbench/harness/faults.py)")
    return p.parse_args(argv)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from perfbench.harness import bench

    sys.exit(bench.main(_args(sys.argv[1:]), T_START, ROOT))
