"""The port's HuggingFace ``datasets`` layer (``sonar_tpu_torch.huggingface``)
against ``sonar_tpu.huggingface`` on the CPU.

The cases of ``test_huggingface.py`` with in-memory ``datasets.Dataset``s,
``device="cpu"`` and the same toy weights in both packages: segmentation
equal, text embeddings within atol 2e-4, speech embeddings within 5e-4,
decoded texts equal. Without ``device`` a pipeline runs on the GPU, and
raises where there is none.
"""

import dataclasses
from pathlib import Path
import sys

import pytest

torch = pytest.importorskip("torch")
datasets = pytest.importorskip("datasets")

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent.parent))
from torch_port_toys import SPEECH_ATOL, TEXT_ATOL, build_toys  # noqa: E402

from sonar_tpu.huggingface import audio as jax_audio  # noqa: E402
from sonar_tpu.huggingface import text as jax_text  # noqa: E402
from sonar_tpu_torch.huggingface import audio, text  # noqa: E402
from sonar_tpu_torch.huggingface.pipeline import (  # noqa: E402
    DatasetConfig,
    Pipeline,
    PipelineConfig,
)

TEXTS = ["Hello world. My name is Dr. Smith! Is it ok? Yes.", "", "One sentence only",
         "Mr. Brown went home. He slept.", "a.b. c! d? e", None]


@pytest.fixture(scope="module")
def toys(tmp_path_factory):
    return build_toys(tmp_path_factory.mktemp("hf"))


def test_split_sentences_matches_jax():
    assert text.split_sentences("Hello world. My name is Dr. Smith! Is it ok? Yes.") == [
        "Hello world.", "My name is Dr. Smith!", "Is it ok?", "Yes."]
    for t in TEXTS[:-1]:
        assert text.split_sentences(t) == jax_text.split_sentences(t)


@pytest.mark.parametrize("policy", ["fill", "skip", "remove"])
def test_segmentation_policies_match_jax(policy):
    cfg = dict(columns=["text"], handle_missing=policy, fill_value="n/a")
    batch = {"text": TEXTS, "id": list(range(len(TEXTS)))}
    got = text.TextSegmentationPipeline(text.TextSegmentationPipelineConfig(**cfg))
    want = jax_text.TextSegmentationPipeline(jax_text.TextSegmentationPipelineConfig(**cfg))
    assert got.process_batch(batch) == want.process_batch(batch)
    with pytest.raises(ValueError, match="handle_missing"):
        text.TextSegmentationPipeline(text.TextSegmentationPipelineConfig(
            columns=["text"], handle_missing="nope")).process_batch({"text": [None]})


def test_segmentation_spacy_model_map():
    assert text.TextSegmentationPipeline.SPACY_MODELS == \
        jax_text.TextSegmentationPipeline.SPACY_MODELS
    assert text.TextSegmentationPipeline._try_spacy("jpn_Jpan") is None
    pipe = text.TextSegmentationPipeline(text.TextSegmentationPipelineConfig(
        columns=["text"], source_lang="jpn_Jpan"))
    assert pipe.process_batch({"text": ["One. Two! Three?"]})["text_output"][0] == [
        "One.", "Two!", "Three?"]


def _embed_cfgs(toys, **kw):
    base = dict(columns=["text", "nested"], batch_size=2, output_column_suffix="emb", **kw)
    return (text.HFTextToEmbeddingPipelineConfig(
                encoder_model=toys.port_encoder, tokenizer=toys.port_tokenizer, device="cpu",
                **base),
            jax_text.HFTextToEmbeddingPipelineConfig(
                encoder_model=toys.jax_encoder, tokenizer=toys.jax_tokenizer, **base))


def _decode_cfgs(toys, columns):
    base = dict(columns=columns, target_lang="eng_Latn", batch_size=2,
                output_column_suffix="text", max_seq_len=6)
    return (text.HFEmbeddingToTextPipelineConfig(
                decoder_model=toys.port_decoder, tokenizer=toys.port_tokenizer, device="cpu",
                **base),
            jax_text.HFEmbeddingToTextPipelineConfig(
                decoder_model=toys.jax_decoder, tokenizer=toys.jax_tokenizer, **base))


def test_hf_text_to_embedding_and_back_match_jax(toys):
    ds = datasets.Dataset.from_dict(
        {"text": ["hello world", "my name is paul", "the cat sat", "bonjour"],
         "nested": [["hello", "world hello"], ["the cat"], [], ["je suis", "a", "mat"]]})
    port_cfg, jax_cfg = _embed_cfgs(toys)
    got = text.HFTextToEmbeddingPipeline(port_cfg)(ds)
    want = jax_text.HFTextToEmbeddingPipeline(jax_cfg)(ds)
    assert [len(v) for v in got["nested_emb"]] == [2, 1, 0, 3]
    np.testing.assert_allclose(np.asarray(got["text_emb"]), np.asarray(want["text_emb"]),
                               atol=TEXT_ATOL)
    for g, w in zip(got["nested_emb"], want["nested_emb"]):
        np.testing.assert_allclose(np.asarray(g).reshape(-1), np.asarray(w).reshape(-1),
                                   atol=TEXT_ATOL)

    port_dec, jax_dec = _decode_cfgs(toys, ["text_emb"])
    back = text.HFEmbeddingToTextPipeline(port_dec)(want)
    ref = jax_text.HFEmbeddingToTextPipeline(jax_dec)(want)
    assert back["text_emb_text"] == ref["text_emb_text"]
    assert all(isinstance(t, str) for t in back["text_emb_text"])


def test_hf_text_to_embedding_flat_and_nested_match_direct_predict(toys):
    """A flat column and a list-of-sentences column equal the port's own
    ``predict`` on the same texts (the same batches), bit for bit."""
    from sonar_tpu_torch.inference_pipelines.text import TextToEmbeddingModelPipeline

    flat = ["hello world", "my name is paul", "the cat sat", "bonjour", "je suis"]
    nested = [flat[:2], flat[2:]]
    port_cfg, _ = _embed_cfgs(toys, sub_batch_size=8)
    pipe = text.HFTextToEmbeddingPipeline(port_cfg)
    out = pipe.process_batch({"text": flat, "nested": nested})
    direct = TextToEmbeddingModelPipeline(toys.port_encoder, toys.port_tokenizer,
                                          device="cpu").predict(flat, source_lang="eng_Latn",
                                                                batch_size=8)
    assert np.array_equal(np.asarray(out["text_emb"], np.float32), direct)
    assert np.array_equal(np.concatenate([np.asarray(v, np.float32)
                                          for v in out["nested_emb"]]), direct)


def test_hf_embedding_to_text_numpy_nested_matches_jax(toys):
    rng = np.random.default_rng(0)
    v = [rng.normal(size=32).astype(np.float32) for _ in range(4)]
    port_cfg, jax_cfg = _decode_cfgs(toys, ["col"])
    pipe, ref = text.HFEmbeddingToTextPipeline(port_cfg), jax_text.HFEmbeddingToTextPipeline(
        jax_cfg)
    for batch in ({"col": [[v[0].tolist(), v[1].tolist()], [v[2].tolist()]]},
                  {"col": [[v[0], v[1]], [v[2]]]},
                  {"col": [np.stack([v[0], v[1]]), np.stack([v[2], v[3]])]},
                  {"col": [v[0], v[1]]}):
        assert pipe.process_batch(batch)["col_text"] == ref.process_batch(batch)["col_text"]
    as_nd = pipe.process_batch({"col": [[v[0], v[1]], [v[2]]]})
    assert [len(x) for x in as_nd["col_text"]] == [2, 1]


def test_dataset_config_sharding():
    ds = datasets.Dataset.from_dict({"x": list(range(10))})
    cfg = DatasetConfig(dataset_name="unused", world_size=2, rank=1)
    assert len(ds.shard(num_shards=cfg.world_size, index=cfg.rank)) == 5


def test_arrow_cache_resume(tmp_path):
    calls = {"n": 0, "fail_after": None}

    class Doubler(Pipeline):
        def process_batch(self, batch):
            calls["n"] += 1
            if calls["fail_after"] is not None and calls["n"] > calls["fail_after"]:
                raise RuntimeError("simulated crash")
            return {"y": [x * 2 for x in batch["x"]]}

    ds = datasets.Dataset.from_dict({"x": list(range(40))})
    cfg = PipelineConfig(batch_size=5, output_path=str(tmp_path / "out"), cache_to_arrow=True,
                         cache_chunk_batches=2)
    calls["fail_after"] = 4
    with pytest.raises(RuntimeError, match="simulated crash"):
        Doubler(cfg)(ds)
    assert calls["n"] == 5
    calls["n"], calls["fail_after"] = 0, None
    result = Doubler(cfg)(ds)
    assert calls["n"] == 4 and result["y"] == [x * 2 for x in range(40)]
    calls["n"] = 0
    assert Doubler(cfg)(ds)["y"] == [x * 2 for x in range(40)] and calls["n"] == 0


def test_hf_audio_to_embedding_matches_jax(toys):
    rng = np.random.default_rng(0)
    mono = (rng.normal(size=4000) * 0.1).astype(np.float32)
    stereo_cf = (rng.normal(size=(2, 4800)) * 0.1).astype(np.float32)
    stereo_cl = (rng.normal(size=(5600, 2)) * 0.1).astype(np.float32)
    for entry in ({"array": stereo_cf}, stereo_cl, mono, None, {"array": None}):
        got, want = audio.normalize_audio(entry), jax_audio.normalize_audio(entry)
        assert (got is None and want is None) or np.array_equal(got, want)
    ds = datasets.Dataset.from_dict({
        "audio": [{"array": mono[None, :].tolist(), "sampling_rate": 16000},
                  {"array": stereo_cf.tolist(), "sampling_rate": 16000},
                  None,
                  {"array": stereo_cl.tolist(), "sampling_rate": 16000}],
        "id": [0, 1, 2, 3]})
    base = dict(columns=["audio"], audio_column="audio", batch_size=4, sub_batch_size=2,
                output_column_suffix="emb")
    got = audio.HFAudioToEmbeddingPipeline(audio.HFAudioToEmbeddingPipelineConfig(
        encoder_model=toys.port_speech, device="cpu", **base))(ds)["audio_emb"]
    want = jax_audio.HFAudioToEmbeddingPipeline(jax_audio.HFAudioToEmbeddingPipelineConfig(
        encoder_model=toys.jax_speech, **base))(ds)["audio_emb"]
    assert got[2] is None and want[2] is None
    for i in (0, 1, 3):
        np.testing.assert_allclose(np.asarray(got[i]), np.asarray(want[i]), atol=SPEECH_ATOL)


def test_hf_audio_skips_a_row_that_fails_to_normalise(toys):
    """A row whose audio cannot be made a float array gives None and the
    other rows are encoded, as in the JAX package."""
    clip = (np.random.default_rng(1).normal(size=5000) * 0.1).astype(np.float32)
    batch = {"audio": [{"array": ["not", "audio"]}, {"array": clip}, {"array": []}]}
    cfg = dict(columns=["audio"], sub_batch_size=2, output_column_suffix="emb")
    got = audio.HFAudioToEmbeddingPipeline(audio.HFAudioToEmbeddingPipelineConfig(
        encoder_model=toys.port_speech, device="cpu", **cfg)).process_batch(batch)["audio_emb"]
    want = jax_audio.HFAudioToEmbeddingPipeline(jax_audio.HFAudioToEmbeddingPipelineConfig(
        encoder_model=toys.jax_speech, **cfg)).process_batch(batch)["audio_emb"]
    assert got[0] is None and got[2] is None and want[0] is None and want[2] is None
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]), atol=SPEECH_ATOL)


def test_pipelines_default_to_the_gpu(toys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert PipelineConfig().device == "cuda"
    builds = [
        lambda: text.HFTextToEmbeddingPipeline(text.HFTextToEmbeddingPipelineConfig(
            encoder_model=toys.port_encoder, tokenizer=toys.port_tokenizer)),
        lambda: text.HFEmbeddingToTextPipeline(text.HFEmbeddingToTextPipelineConfig(
            decoder_model=toys.port_decoder, tokenizer=toys.port_tokenizer)),
        lambda: audio.HFAudioToEmbeddingPipeline(audio.HFAudioToEmbeddingPipelineConfig(
            encoder_model=toys.port_speech)),
    ]
    for build in builds:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    cfg = dataclasses.replace(text.HFTextToEmbeddingPipelineConfig(
        encoder_model=toys.port_encoder, tokenizer=toys.port_tokenizer), device="cpu")
    assert text.HFTextToEmbeddingPipeline(cfg)._pipeline.device == torch.device("cpu")
