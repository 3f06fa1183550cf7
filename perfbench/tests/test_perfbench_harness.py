"""The harness's arithmetic, its files and its rules, on the CPU."""

import ast
import json
from pathlib import Path
import re
import subprocess
import sys

import numpy as np
import pytest

from perfbench.harness import guard, kernels, roofline, trace, traffic
from perfbench.tests.conftest import ROOT

PACKAGE = ROOT / "perfbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_traffic_is_a_function_of_the_seed():
    words = [f"w{i}" for i in range(500)]
    spec = json.loads((PACKAGE / "traffic" / "text_embed.short.json").read_text())
    a = traffic.text_pool(words, spec["lengths"], 300, 2, 2**31 + 5)
    b = traffic.text_pool(words, spec["lengths"], 300, 2, 2**31 + 5)
    c = traffic.text_pool(words, spec["lengths"], 300, 2, 2**31 + 6)
    assert a == b and a != c
    # every seed gets the same lengths, in another order
    assert sorted(len(s.split()) for s in sum(a, [])) == sorted(len(s.split()) for s in sum(c, []))
    e1, e2 = traffic.embeddings(8, 16, 1.0, 3), traffic.embeddings(8, 16, 1.0, 3)
    assert np.array_equal(e1, e2)


def test_lengths_follow_the_traffic_files():
    lens = traffic.token_lengths({"dist": "lognormal", "mu": 2.9, "sigma": 0.55,
                                  "min": 4, "max": 126}, 8192)
    assert lens.min() >= 4 and lens.max() <= 126
    assert abs(np.median(lens) - np.exp(2.9)) <= 1
    lens = traffic.token_lengths({"dist": "uniform", "min": 257, "max": 510}, 1024)
    assert lens.min() == 257 and lens.max() == 510


def test_the_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(["sonar_tpu_torch", "sonar_tpu_torch.ops", "torch"]) == []
    assert guard.forbidden_modules(["sonar_tpu.models"]) == ["sonar_tpu"]
    assert guard.forbidden_modules(["jax", "jaxlib.xla", "flax.linen"]) == ["flax", "jax", "jaxlib"]
    assert guard.forbidden_modules(["jaxtyping", "flaxen"]) == []


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_references_import_nothing_of_jax_or_the_program():
    for path in sorted((PACKAGE / "reference").glob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "sonar_tpu", "sonar_tpu_torch"}, path
        assert tops <= {"__future__", "math", "typing", "torch", "perfbench"}, (path, tops)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in sorted(PACKAGE.rglob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "sonar_tpu"}, path


def test_frozen_counts_against_hand_worked_values():
    # fused_int8_ffn at M 8192, D 1024, F 8192: 4 M D F int8 operations
    moved, ops = roofline.int8_ffn_work(8192, 1024, 8192)
    assert ops == {"int8": 4 * 8192 * 1024 * 8192}
    assert moved == 2 * 8192 * 1024 * 2 + 2 * 1024 * 8192 + 8 * (8192 + 1024) + 8 * 1024
    assert roofline.bound_s(moved, ops) == pytest.approx(2.748779e11 / 1979e12)  # 0.1389 ms
    # flash at [16, 16, 512, 64]: bytes-bound, 0.0200 ms
    moved, ops = roofline.flash_work(16, 16, 512, 64)
    assert ops == {"bf16": 4 * 16 * 16 * 512 * 512 * 64}
    assert roofline.bound_s(moved, ops) == pytest.approx(moved / 3.35e12)
    assert roofline.bound_s(moved, ops) * 1e3 == pytest.approx(0.02005, abs=1e-4)
    # fused_attn_block at [64, 128, 1024]: 8 M D^2 int8 + 4 B S^2 D bf16, 0.0391 ms
    moved, ops = roofline.attn_block_work(64, 128, 1024)
    assert ops == {"int8": 8 * 8192 * 1024 ** 2, "bf16": 4 * 64 * 128 ** 2 * 1024}
    assert roofline.bound_s(moved, ops) * 1e3 == pytest.approx(0.03908, abs=1e-4)
    # a decode step of the basic decoder at 160 rows and a cache of 10
    f = roofline.decoder_step_flops(1024, 8192, 24, 256206, 160, 10)
    assert f == 160 * (24 * (8 * 1024 ** 2 + 4 * 1024 * 8192 + 4 * 10 * 1024) + 2 * 1024 * 256206)
    step = roofline.decoder_step_flops
    assert roofline.decode_flops([2], 1, 4, 8, 1, 10) == (step(4, 8, 1, 10, 1, 1)
                                                          + step(4, 8, 1, 10, 1, 2))
    needed = roofline.encoder_needed_ops([3, 5], 4, 8, 2)
    assert needed == {"int8": 2 * 8 * (8 * 16 + 4 * 32), "bf16": 2 * 4 * 4 * (9 + 25)}


def test_busy_time_is_a_union_and_gaps_are_named_by_the_host():
    dev = [("k1", 0.0, 2.0), ("k2", 1.0, 3.0), ("Memcpy HtoD", 5.0, 6.0)]
    host = [("outer", 0.0, 10.0), ("aten::tokenize", 3.0, 5.0)]
    s = trace.summarize(dev, host, (0.0, 10.0))
    assert s.busy_s == 4.0 and s.window_s == 10.0
    assert trace.merged([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    assert s.idle_gaps[0] == ("outer", 4.0)  # 6..10
    assert s.idle_gaps[1] == ("aten::tokenize", 2.0)  # 3..5: the innermost host op
    assert [k[0] for k in s.kernels] == ["k1", "k2"]  # copies are not kernels
    assert s.device_ops[0] == ("k1", 2.0)


def test_kernel_launches_are_found_by_name_and_order():
    seq = [("void row_quant_kernel<__nv_bfloat16, true, 4>(...)", 0, 1.0),
           ("void gemm_s8_kernel<0, __nv_bfloat16>(...)", 1, 2.0),
           ("void tc_attn_one_pass<64, 8>(...)", 3, 3.0),
           ("void row_quant_kernel<float, false, 4>(...)", 6, 1.0),
           ("void gemm_s8_kernel<2, __nv_bfloat16>(...)", 7, 2.0),
           ("void row_quant_kernel<__nv_bfloat16, true, 4>(...)", 9, 1.0),
           ("void gemm_s8_kernel<1, float>(...)", 10, 4.0),
           ("void row_quant_kernel<float, false, 4>(...)", 14, 1.0),
           ("void gemm_s8_kernel<3, __nv_bfloat16>(...)", 15, 4.0),
           ("void tc_attn_two_pass<64, 4, 8, __nv_bfloat16>(...)", 19, 5.0)]
    assert kernels.launches(seq, kernels.ATTN_BLOCK_EPI) == [9.0]
    assert kernels.launches(seq, kernels.FFN_EPI) == [10.0]
    assert kernels.flash(seq) == [5.0]


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    names = [c["name"] for c in BENCH["configs"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for n in names + cells + metrics + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
        assert c["reduced"] == [] and len(c["why"]) <= 200
        assert c["name"] in {w["config"] for w in BENCH["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(cells)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (PACKAGE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (PACKAGE / "limits" / f"{w['name']}.json").is_file()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert all(w in cells and w in e2e[m["moves"]].get("workloads", cells)
                   for w in m["workloads"])
        assert (PACKAGE / "metrics" / f"{m['name']}.py").is_file()
    for w in cells:  # every cell reports set-up, another end-to-end metric, a per-layer one
        assert sum(w in m.get("workloads", cells) for m in BENCH["end_to_end"]) >= 2
        assert any(w in m["workloads"] for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_the_measured_command_fails_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is here")
    out = subprocess.run([sys.executable, str(PACKAGE / "run.py"), "--workload",
                          "text_embed.short", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_command_fails_in_a_checkout_without_the_program(tmp_path):
    import shutil

    shutil.copytree(PACKAGE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "text_embed.short",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
