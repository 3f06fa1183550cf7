"""The port's runtime base (``sonar_tpu_torch.runtime``) on the CPU toy
models: each runtime's row rule over a mesh's data axis, the one
dispatch-ahead window under ``encode_batches`` / ``encode_batches_iter``,
and ``predict``'s batches going through the instance's ``encode_batch``
(the attribute the benchmark's span wraps)."""

from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from sonar_tpu_torch.assets import convert  # noqa: E402
from sonar_tpu_torch.data.collate import SequenceBatch  # noqa: E402
from sonar_tpu_torch.inference_pipelines.text import (  # noqa: E402
    TextToEmbeddingModelPipeline,
    TorchTextEncoder,
)
from sonar_tpu_torch.models.sonar_text import sonar_text_encoder_archs  # noqa: E402
from sonar_tpu_torch.parallel.comm import SINGLE  # noqa: E402
from sonar_tpu_torch.parallel.mesh import SINGLE_MESH, Mesh  # noqa: E402
from sonar_tpu_torch.runtime import (  # noqa: E402
    ENCODER_ROWS,
    POW2_ROWS,
    SCORE_ROWS,
    row_split,
    split_rows,
)
from sonar_tpu_torch.tokenizers.nllb import NllbTokenizer  # noqa: E402
from sonar_tpu_torch.tokenizers.spm_proto import (  # noqa: E402
    PIECE_CONTROL,
    PIECE_UNKNOWN,
    ModelProto,
    NormalizerSpecProto,
    SentencePieceProto as P,
    TrainerSpecProto,
    serialize_model_proto,
)

TEXTS = ["hello world", "the cat sat on the mat " * 5, "a", "hello " * 20, "the cat",
         "world", "sat hello the cat world", "b c d e f g h i j k", "hello", "cat sat"]


def _data_mesh(rank: int) -> Mesh:
    """Data index ``rank`` of a (data 2, model 1) mesh; no collective runs."""
    return Mesh(data=2, model=1, rank=rank, data_group=SINGLE, model_group=SINGLE,
                world=SINGLE)


# rule, the fill each runtime pads with, numpy or a tensor, padded rows of 5
# at data 2 and at data 1
RULES = {
    "text": (ENCODER_ROWS, 1, "numpy", 6, 5),
    "speech": (POW2_ROWS, 0, "numpy", 8, 8),
    "decoder_score": (SCORE_ROWS, 0, "torch", 8, 5),
    "decoder_beam": (POW2_ROWS, 0, "torch", 8, 8),
}


@pytest.mark.parametrize("name", sorted(RULES))
def test_row_split_keeps_each_runtimes_rule(name):
    rule, fill, kind, padded_data2, padded_alone = RULES[name]
    x = np.arange(4, 4 + 5 * 3, dtype=np.int32).reshape(5, 3)
    if kind == "torch":
        x = torch.from_numpy(x)
    want = np.concatenate([np.asarray(x), np.full((padded_data2 - 5, 3), fill, np.int32)])
    per = padded_data2 // 2
    for rank in (0, 1):
        mesh = _data_mesh(rank)
        got = split_rows(x, mesh, rule, fill)
        assert row_split(5, mesh, rule) == (padded_data2, slice(rank * per, (rank + 1) * per))
        assert type(got) is type(x)
        np.testing.assert_array_equal(np.asarray(got), want[rank * per:(rank + 1) * per])
    got = split_rows(x, SINGLE_MESH, rule, fill)
    assert row_split(5, SINGLE_MESH, rule)[0] == len(got) == padded_alone
    np.testing.assert_array_equal(np.asarray(got)[:5], np.asarray(x))
    assert (np.asarray(got)[5:] == fill).all()
    if padded_alone == 5:
        assert got is x


@pytest.fixture(scope="module")
def encoder():
    cfg = sonar_text_encoder_archs.get("toy")
    return TorchTextEncoder(
        convert.text_encoder_from_numpy(convert.init_text_encoder_params(cfg, 0), cfg),
        device="cpu")


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for rows, length in ((4, 8), (3, 16), (8, 8), (2, 12), (5, 16), (1, 8)):
        lens = rng.integers(1, length + 1, rows).astype(np.int32)
        seqs = np.ones((rows + 1, length), np.int32)
        for i, n in enumerate(lens):
            seqs[i, :n] = rng.integers(4, 30, n)
        out.append(SequenceBatch(seqs=seqs, seq_lens=np.append(lens, 0), true_batch=rows))
    return out


@pytest.mark.parametrize("window", [1, 2, 64])
def test_one_window_for_every_dispatch_ahead(encoder, window, monkeypatch):
    """Streamed or listed, the batches' embeddings are per-batch
    ``encode_batch``'s bit for bit, and at most ``window`` + 1 batches are
    enqueued before the first copy-out (all of them for ``encode_batches``)."""
    batches = _batches()
    want = [encoder.encode_batch(b) for b in batches]
    events = []
    enqueue, copy_out = encoder.encode_batch, encoder.to_host

    def spy_enqueue(*args, **kwargs):
        events.append("enqueue")
        return enqueue(*args, **kwargs)

    def spy_copy_out(emb):
        events.append("copy_out")
        return copy_out(emb)

    monkeypatch.setattr(encoder, "encode_batch", spy_enqueue, raising=False)
    monkeypatch.setattr(encoder, "to_host", spy_copy_out, raising=False)
    for run, ahead in (
            (lambda: encoder.encode_batches_iter(iter(batches), max_pending=window),
             min(window + 1, len(batches))),
            (lambda: encoder.encode_batches(batches), len(batches))):
        got = run()
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert events.count("enqueue") == events.count("copy_out") == len(batches)
        assert events.index("copy_out") == ahead
        events.clear()


def _tokenizer(tmp_path: Path) -> NllbTokenizer:
    pieces = [P("<blank>", 0.0, PIECE_CONTROL), P("<unk>", 0.0, PIECE_UNKNOWN),
              P("<s>", 0.0, PIECE_CONTROL), P("</s>", 0.0, PIECE_CONTROL)]
    pieces += [P("▁" + w, -1.0) for w in ("hello", "world", "the", "cat", "sat")]
    pieces += [P(c, -5.0) for c in "abcdefghijklmnopqrstuvwxyz"] + [P("▁", -4.0)]
    proto = ModelProto(pieces=pieces,
                       trainer=TrainerSpecProto(unk_id=1, bos_id=2, eos_id=3, pad_id=1),
                       normalizer=NormalizerSpecProto())
    path = tmp_path / "t.model"
    path.write_bytes(serialize_model_proto(proto))
    return NllbTokenizer(path, langs=["eng_Latn", "fra_Latn"])


@pytest.mark.parametrize("batching", ["static", "dynamic"])
def test_an_instance_encode_batch_sees_every_batch(encoder, batching, tmp_path, monkeypatch):
    """A function set on the encoder instance as ``encode_batch`` (as the
    benchmark's span wraps it) sees every batch that ``predict`` encodes,
    and ``predict`` returns what it did without it."""
    pipe = TextToEmbeddingModelPipeline(encoder, _tokenizer(tmp_path))
    kwargs = dict(source_lang="eng_Latn", batch_size=3, batch_max_tokens=64,
                  batching=batching)
    want = pipe.predict(TEXTS, **kwargs)
    seen = []
    inner = encoder.encode_batch

    def encode_batch(batch, *args, **kwargs):
        seen.append(batch.true_batch)
        return inner(batch, *args, **kwargs)

    monkeypatch.setattr(encoder, "encode_batch", encode_batch, raising=False)
    np.testing.assert_array_equal(pipe.predict(TEXTS, **kwargs), want)
    assert len(seen) > 1 and sum(seen) == len(TEXTS)
