"""Run one benchmark cell of an encoder-decoder configuration
(``translate.moe_beam5``) and print, after its check, the share of routing
decisions that bf16 flips:

    python3 scripts/nllb_moe_flips.py -- --workload translate.moe_beam5 \\
        --seed N --seconds S --trace 0

The plain reference runs teacher-forced over the sampled rows' sources and
best hypotheses twice, in fp32 and with every projection's input and weight
rounded to bf16 (the program's precision; the router stays fp32), and the
share of (token, sparse layer) pairs whose top-2 experts differ is printed
to standard error. Not a measured run: the check runs the reference two
more times."""

import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402
from typing import Any, Callable, List  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def flips(ref: Any, tree: dict, m: dict, sources: List[List[int]],
          seqs: List[List[int]]) -> None:
    import torch

    routes = {}
    for quant in (None, "bf16"):
        routes[quant] = []
        for _ in ref.log_probs(tree, m, sources, seqs, quant=quant, routes=routes[quant]):
            pass
    a, b = (torch.cat(routes[q]) for q in (None, "bf16"))
    differ = (a.sort(dim=-1).values != b.sort(dim=-1).values).any(dim=-1)
    print(f"# routing flips, fp32 against bf16: {int(differ.sum())} of {differ.numel()} "
          f"(token, sparse layer) pairs ({100.0 * float(differ.float().mean()):.3f}%); "
          f"top-1 differs in {int((a[:, 0] != b[:, 0]).sum())}", file=sys.stderr)


def plant() -> Callable[[], None]:
    """Wrap the check of the driver that ``bench`` loads so that the flips
    follow it; returns the call that takes the wrapper out."""
    from perfbench.harness import bench
    from perfbench.reference import spm

    load = bench.driver

    def driver(traffic: dict) -> Any:
        module = load(traffic)
        inner = module.compare

        def compare(cell, cfg, t, tree, pieces, texts, served, prefix):
            checks = inner(cell, cfg, t, tree, pieces, texts, served, prefix)
            rows = sorted(served, key=lambda r: -int(r["len"]))[:t["sample"]]
            tok = spm.Tokenizer(pieces.pieces, pieces.scores, pieces.types, pieces.symbols)
            sources = [tok.encode_source(texts[r["row"]], t["source_lang"])
                       [:cfg["model"]["max_seq_len"]] for r in rows]
            seqs = [prefix + [int(x) for x in r["hyps"][0][0]][:-1] for r in rows]
            flips(bench.reference(cfg), tree, cfg["model"], sources, seqs)
            return checks

        module.compare = compare
        return module

    bench.driver = driver
    return lambda: setattr(bench, "driver", load)


def main(argv):
    rest = argv[argv.index("--") + 1:]
    sys.path.insert(0, str(ROOT))
    import importlib.util

    spec = importlib.util.spec_from_file_location("perfbench_run", ROOT / "perfbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    from perfbench.harness import bench

    undo = plant()
    try:
        return bench.main(run._args(rest), T_START, ROOT)
    finally:
        undo()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
