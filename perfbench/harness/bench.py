"""One run of one cell: load its files by name, check the device, run the
driver, reduce the trace, judge the outputs, print the result.

Everything that belongs to one cell is found from ``BENCHMARK.json`` by
name:

- the configuration: the ``file`` of its ``configs`` entry, which names its
  plain reference (``perfbench/reference/<reference>.py``);
- the traffic: ``perfbench/traffic/<traffic>.json``, which names the entry
  driver that runs it (``perfbench/drivers/<driver>.py``);
- the limits of the numbers compared: ``perfbench/limits/<workload>.json``;
- each per-layer metric: ``perfbench/metrics/<name>.py``, whose ``read``
  takes the run's observations and returns a number, or None where it finds
  nothing to read.
"""

from __future__ import annotations

from dataclasses import dataclass, field
import importlib.util
import json
import math
import os
from pathlib import Path
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple

from perfbench.harness import guard

PACKAGE = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    """What a driver is given: the cell's entries and files, the run's
    arguments and the device."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    control: bool
    device: Any
    t_start: float
    scale: dict = field(default_factory=dict)  # tests: smaller sizes


@dataclass
class Outcome:
    """What a driver returns."""

    attempted: int
    failed: int
    metrics: Dict[str, float]             # end-to-end, host clock
    setup_s: float
    checks: List[Tuple[str, float, float]]  # (name, reading, limit)
    memory_peak_bytes: int
    observations: Dict[str, Any]          # for the per-layer readers
    trace: Optional[Any] = None           # trace.Summary of the traced unit


def load_module(path: Path, name: Optional[str] = None):
    """The module in the file ``path`` (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name or f"perfbench_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return read_json(path)


def resolve(bench: dict, workload: str, root: Path) -> Tuple[dict, dict, dict, dict]:
    """(workload, config, traffic, limits) entries and files of a cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = read_json(root / cfg_entry["file"])
    traffic = read_json(PACKAGE / "traffic" / f"{w['traffic']}.json")
    limits_path = PACKAGE / "limits" / f"{workload}.json"
    limits = read_json(limits_path) if limits_path.is_file() else {}
    return w, config, traffic, limits


def driver(traffic: dict):
    return load_module(PACKAGE / "drivers" / f"{traffic['driver']}.py",
                       f"perfbench_driver_{traffic['driver']}")


def reference(config: dict):
    return load_module(PACKAGE / "reference" / f"{config['reference']}.py",
                       f"perfbench_reference_{config['reference']}")


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    (each metric lists its cells, or is in every cell), or with ``trace``
    the per-layer metrics that read in it."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def per_layer(bench: dict, workload: str, observations: dict) -> Dict[str, dict]:
    out = {}
    for m in cell_metrics(bench, workload, trace=True):
        reader = load_module(PACKAGE / "metrics" / f"{m['name']}.py",
                             "perfbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(observations)
        if value is None:
            print(f"# {m['name']}: nothing to read in this run", file=sys.stderr)
            continue
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(checks: List[Tuple[str, float, float]]) -> bool:
    """Every reading at or under its limit (a NaN fails)."""
    return all(isinstance(v, (int, float)) and not math.isnan(v) and v <= lim
               for _, v, lim in checks)


def result_line(correct: bool, outcome: Outcome, metrics: Dict[str, dict], device: dict,
                breakdown: Optional[dict]) -> str:
    line: Dict[str, Any] = {"correct": correct, "attempted": outcome.attempted,
                            "failed": outcome.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in outcome.checks}
    return json.dumps(line)


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own kernels build into ``build/sonar_tpu_torch``)."""
    cache = root / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    for name in ("USE_FLAX", "USE_JAX", "USE_TF"):  # no library may load JAX by itself
        os.environ[name] = "0"


def run(args, t_start: float, root: Path, device: Any = None,
        scale: Optional[dict] = None, on_line: Callable[[str], None] = print) -> int:
    """Run the cell; ``device`` None means the GPU, which must be there.
    Returns the exit code."""
    bench = benchmark(root)
    w, config, traffic, limits = resolve(bench, args.workload, root)
    if scale and "model" in scale:  # tests: the configuration at a size a CPU holds
        config = dict(config, model=dict(config["model"], **scale["model"]))
    set_cache_dirs(root)
    import torch

    from perfbench.harness import devices, trace as tracing

    if device is None:
        err = devices.require(torch, w["chips"])
        if err:
            print(err, file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    cell = Cell(name=args.workload, workload=w, config=config, traffic=traffic, limits=limits,
                seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                control=bool(getattr(args, "control", False)), device=torch.device(device),
                t_start=t_start, scale=dict(scale or {}))
    undo = None
    if getattr(args, "fault", None):
        from perfbench.harness import faults

        undo = faults.plant(args.fault)
    try:
        outcome: Outcome = driver(traffic).run(cell)
    finally:
        if undo is not None:
            undo()

    found = guard.forbidden_modules(sys.modules)
    if found:
        print(f"forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 4

    if cell.trace:
        observations = dict(outcome.observations, trace=outcome.trace)
        metrics = per_layer(bench, args.workload, observations)
    else:
        names = [m["name"] for m in cell_metrics(bench, args.workload, trace=False)]
        values = dict(outcome.metrics, setup_s=outcome.setup_s)
        metrics = {}
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        for name in names:
            if name not in values:
                print(f"# end-to-end metric {name} was not measured", file=sys.stderr)
                return 5
            metrics[name] = {"value": values[name], "unit": units[name]}
    device_info = devices.describe(torch, cell.device, outcome.memory_peak_bytes)
    breakdown = None
    if cell.trace and outcome.trace is not None:
        device_info["busy_s"] = outcome.trace.busy_s
        device_info["window_s"] = outcome.trace.window_s
        breakdown = tracing.breakdown(outcome.trace)
    correct = judge(outcome.checks) and outcome.failed == 0
    for name, v, lim in outcome.checks:
        print(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    on_line(result_line(correct, outcome, metrics, device_info, breakdown))
    return 0


def main(args, t_start: float, root: Path) -> int:
    try:
        return run(args, t_start, root)
    except Exception:
        import traceback

        traceback.print_exc()
        return 1
