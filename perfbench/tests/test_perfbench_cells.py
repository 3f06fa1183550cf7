"""Every cell run on the CPU at toy width through the whole of a run but the
look for a card: the result line, the plain reference against the port, the
controls, and the faults that ``correct`` has to catch."""

import contextlib
import json

import numpy as np
import pytest

from perfbench.tests.conftest import ROOT, run_cell

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_port_agrees_with_the_plain_reference(workload):
    line = run_cell(workload)
    assert list(line) == KEYS  # the checks last
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) >= {"setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("workload", ["text_embed.short", "decode.beam5"])
def test_a_traced_run_reports_per_layer_metrics(workload):
    line = run_cell(workload, trace=1)
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["metrics"] and all(m["unit"] for m in line["metrics"].values())
    assert line["correct"] is True


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    assert run_cell(workload, control=True)["correct"] is False


@contextlib.contextmanager
def patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def _half_batch(old):
    """Half of the batch left out, the mean of the rest in its place."""
    def encode(self, seqs, lens):
        emb = old(self, seqs, lens).clone()
        half = max(1, emb.shape[0] // 2)
        emb[half:] = emb[:half].mean(0)
        return emb
    return encode


def _altered_answer(old):
    """Every eighth embedding of a batch altered where it is produced (the
    check reads a sample: a fault that touches one answer in a thousand
    escapes it; ``PERF.md``)."""
    def encode(self, seqs, lens):
        emb = old(self, seqs, lens).clone()
        emb[::8] = emb[::8] * 1.5
        return emb
    return encode


@pytest.mark.parametrize("workload", ["text_embed.short", "text_embed.long"])
@pytest.mark.parametrize("fault", [_half_batch, _altered_answer])
def test_a_broken_encoder_is_not_correct(workload, fault):
    from sonar_tpu_torch.inference_pipelines.text import TorchTextEncoder

    with patched(TorchTextEncoder, "_encode", fault):
        assert run_cell(workload)["correct"] is False


def _stale_step(old):
    """A decoder step that returns its state unchanged: the cache is not
    written and its position does not advance."""
    def step(self, tokens, cache, *args, **kwargs):
        import copy

        logits, _ = old(self, tokens, copy.deepcopy(cache), *args, **kwargs)
        return logits, cache
    return step


def _altered_token(old):
    """A served token altered where the search hands it back."""
    def materialize(handle):
        tokens, scores, lens = old(handle)
        tokens = np.array(tokens)
        tokens[:, 0, 1] = (tokens[:, 0, 1] + 7) % 2000 + 4
        return tokens, scores, lens
    return materialize


def test_a_stale_decoder_step_is_not_correct():
    from sonar_tpu_torch.nn.conditional_decoder import ConditionalTransformerDecoder

    with patched(ConditionalTransformerDecoder, "step", _stale_step):
        assert run_cell("decode.beam5")["correct"] is False


def test_a_wrong_shortlist_is_not_correct():
    """The beam search's candidates from a strided sample of the vocabulary
    (``faults.shortlist``): its hypotheses score their own tokens
    consistently, and only the selection check sees it."""
    line = run_cell("decode.beam5", fault="shortlist")
    assert line["correct"] is False
    assert line["checks"]["pick_gap"]["value"] > line["checks"]["pick_gap"]["limit"]
    assert line["checks"]["score_gap"]["value"] <= line["checks"]["score_gap"]["limit"]


def test_an_altered_token_is_not_correct():
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder

    old = TorchTextDecoder.__dict__["materialize_beam"]
    TorchTextDecoder.materialize_beam = staticmethod(_altered_token(old.__func__))
    try:
        assert run_cell("decode.beam5")["correct"] is False
    finally:
        TorchTextDecoder.materialize_beam = old


@pytest.mark.gpu
def test_a_short_run_on_the_card(card):
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "text_embed.short",
                          "--seed", "424242", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert out.returncode == 0 and line["correct"] is True
    assert line["device"]["platform"] == "gpu"
