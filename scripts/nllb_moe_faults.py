"""Run one benchmark cell with one of ``perfbench/harness/moe_faults.py``'s
faults planted in the program, which ``correct`` has to catch:

    python3 scripts/nllb_moe_faults.py NAME -- --workload translate.moe_beam5 \\
        --seed N --seconds S --trace 0

prints the cell's result line as ``perfbench/run.py`` does. Not a measured
run."""

import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv):
    name, rest = argv[0], argv[argv.index("--") + 1:]
    sys.path.insert(0, str(ROOT))
    import importlib.util

    spec = importlib.util.spec_from_file_location("perfbench_run", ROOT / "perfbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    from perfbench.harness import bench, moe_faults

    undo = moe_faults.plant(name)
    try:
        return bench.main(run._args(rest), T_START, ROOT)
    finally:
        undo()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
