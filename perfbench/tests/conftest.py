"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from the
root of the repository (the CPU ones run anywhere; those marked ``gpu``
skip without a CUDA device)."""

from pathlib import Path
import sys
import time
import types

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

VOCAB = {"size": 2048, "unk_idx": 1, "bos_idx": 2, "eos_idx": 3, "pad_idx": 1}
# The configurations at a width a CPU holds: heads of 64 as published, two layers.
TOY_ENCODER = {"model_dim": 128, "num_encoder_layers": 2, "num_encoder_attn_heads": 2,
               "num_decoder_attn_heads": 2, "ffn_inner_dim": 256, "vocab_info": VOCAB}
TOY_DECODER = {"model_dim": 128, "num_decoder_layers": 4, "num_encoder_attn_heads": 2,
               "num_decoder_attn_heads": 2, "ffn_inner_dim": 256, "vocab_info": VOCAB}


def toy_scale(workload: str) -> dict:
    decode = workload.startswith("decode")
    return {"model": TOY_DECODER if decode else TOY_ENCODER, "chunk": 64 if decode else 256,
            "pool_chunks": 2, "sample": 16 if decode else 48, "warm_seconds": 0}


def run_cell(workload: str, seed: int = 2**31 + 7, trace: int = 0, control: bool = False,
             fault: str = None, seconds: float = 0.5, root: Path = ROOT) -> dict:
    """One run of ``workload`` on the CPU at toy width, through everything a
    measured run does but the look for a card -> its result line."""
    import json

    from perfbench.harness import bench

    lines = []
    args = types.SimpleNamespace(workload=workload, seed=seed, seconds=seconds, trace=trace,
                                 control=control, fault=fault)
    rc = bench.run(args, time.perf_counter(), root, device="cpu", scale=toy_scale(workload),
                   on_line=lines.append)
    assert rc == 0 and len(lines) == 1
    return json.loads(lines[0])


@pytest.fixture
def card():
    """The CUDA device, or a skip."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)

