"""The port stands alone and runs on the GPU unless asked for the CPU.

- a fresh interpreter in which ``jax`` and ``sonar_tpu`` (and ``datasets``,
  which the card's machine lacks) cannot be imported imports every module
  of ``sonar_tpu_torch`` and runs text, speech, decode (beam, sampling,
  int8), speech -> text and MuTox ``predict``, the three heads, mining,
  packed encoding, the HF batch layer on plain dicts, one ``/embed``
  request through the server and its client, one training step with a
  checkpoint round trip, and a world-1 gloo mesh encode and sharded top-k
  (each equal to the mesh-free result) on the CPU at toy size;
- no file of the port, and not ``chip_smoke.py``, imports ``sonar_tpu`` or
  ``jax`` (an ``ast`` scan);
- with no GPU, every entry point given ``device=None`` raises instead of
  running on the CPU.
"""

import ast
import os
from pathlib import Path
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

REPO = Path(__file__).resolve().parents[2]
PORT_FILES = sorted((REPO / "sonar_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]

SCRIPT = r"""
import importlib, pkgutil, sys
from pathlib import Path
sys.modules["jax"] = None        # any import of jax now raises ImportError
sys.modules["sonar_tpu"] = None  # and so does any import of the JAX package
sys.modules["datasets"] = None   # the HF layer imports it only where a dataset is loaded
import numpy as np
import sonar_tpu_torch

for info in pkgutil.walk_packages(sonar_tpu_torch.__path__, "sonar_tpu_torch."):
    importlib.import_module(info.name)

from sonar_tpu_torch.assets import convert
from sonar_tpu_torch.inference_pipelines.speech import SpeechToEmbeddingModelPipeline
from sonar_tpu_torch.inference_pipelines.text import (
    EmbeddingToTextModelPipeline, TextToEmbeddingModelPipeline, TextToTextModelPipeline)
from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs
from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs, sonar_text_encoder_archs
from sonar_tpu_torch.tokenizers.nllb import NllbTokenizer
from sonar_tpu_torch.tokenizers.spm_proto import (
    PIECE_CONTROL, PIECE_UNKNOWN, ModelProto, NormalizerSpecProto, SentencePieceProto as P,
    TrainerSpecProto, serialize_model_proto)

pieces = [P("<blank>", 0.0, PIECE_CONTROL), P("<unk>", 0.0, PIECE_UNKNOWN),
          P("<s>", 0.0, PIECE_CONTROL), P("</s>", 0.0, PIECE_CONTROL)]
pieces += [P("▁" + w, -1.0) for w in ("hello", "world", "the", "cat", "sat")]
pieces += [P(c, -5.0) for c in "abcdefghijklmnopqrstuvwxyz"] + [P("▁", -4.0)]
proto = ModelProto(pieces=pieces, trainer=TrainerSpecProto(unk_id=1, bos_id=2, eos_id=3, pad_id=1),
                   normalizer=NormalizerSpecProto())
path = Path(sys.argv[1]) / "t.model"
path.write_bytes(serialize_model_proto(proto))
tok = NllbTokenizer(path, langs=["eng_Latn", "fra_Latn"])

cfg = sonar_text_encoder_archs.get("toy")
enc = convert.text_encoder_from_numpy(convert.init_text_encoder_params(cfg, 0), cfg)
emb = TextToEmbeddingModelPipeline(enc, tok, device="cpu").predict(
    ["hello world", "the cat sat"], source_lang="eng_Latn")
assert emb.shape == (2, 32) and np.isfinite(emb).all()

scfg = sonar_speech_encoder_archs.get("toy")
senc = convert.speech_encoder_from_numpy(convert.init_speech_encoder_params(scfg, 0), scfg)
rng = np.random.default_rng(0)
semb = SpeechToEmbeddingModelPipeline(senc, device="cpu").predict(
    [rng.standard_normal(n).astype(np.float32) * 0.1 for n in (9000, 3000)])
assert semb.shape == (2, 32) and np.isfinite(semb).all()

import dataclasses
dcfg = sonar_text_decoder_archs.get("toy")
dcfg = dataclasses.replace(dcfg, vocab_info=dataclasses.replace(dcfg.vocab_info,
                                                                size=tok.vocab_info.size))
dec = convert.text_decoder_from_numpy(convert.init_text_decoder_params(dcfg, 0), dcfg)
texts = EmbeddingToTextModelPipeline(dec, tok, device="cpu").predict(
    emb, target_lang="fra_Latn", beam_size=2, max_gen_len=5)
assert len(texts) == 2 and all(isinstance(t, str) for t in texts)
texts = TextToTextModelPipeline(enc, dec, tok, device="cpu").predict(
    ["hello world"], source_lang="eng_Latn", target_lang="fra_Latn", max_gen_len=5)
assert len(texts) == 1

from sonar_tpu_torch.generation.sampling import TopKSampler, TopPSampler
for sampler in (TopPSampler(0.9, max_candidates=8), TopKSampler(3)):
    texts = EmbeddingToTextModelPipeline(dec, tok, device="cpu").predict(
        emb, target_lang="fra_Latn", sampler=sampler, max_gen_len=5)
    assert len(texts) == 2
texts = EmbeddingToTextModelPipeline(dec, tok, device="cpu", quantize=True).predict(
    emb, target_lang="fra_Latn", beam_size=2, max_gen_len=5)
assert len(texts) == 2

from sonar_tpu_torch.inference_pipelines.speech import SpeechToTextModelPipeline
waves = [rng.standard_normal(n).astype(np.float32) * 0.1 for n in (9000, 3000)]
texts = SpeechToTextModelPipeline(senc, dec, tok, device="cpu").predict(
    waves, target_lang="fra_Latn", beam_size=2, max_gen_len=5)
assert len(texts) == 2

from sonar_tpu_torch.inference_pipelines.mutox_speech import MutoxSpeechClassifierPipeline
from sonar_tpu_torch.models import blaser, laser2_text, mutox
mcfg = mutox.MutoxConfig(32)
classifier = convert.mutox_from_numpy(convert.init_mutox_params(mcfg), mcfg, "cpu")
scores = MutoxSpeechClassifierPipeline(classifier, senc, device="cpu").predict(
    waves, output_prob=True)
assert scores.shape == (2, 1) and ((scores >= 0) & (scores <= 1)).all()
bcfg = blaser.blaser_archs.get("basic_qe")
x = rng.standard_normal((2, 1024)).astype(np.float32)
bmodel = convert.blaser_from_numpy(convert.init_blaser_params(bcfg), bcfg, "cpu")
assert bmodel(x, x).shape == (2, 1)
lcfg = laser2_text.laser2_archs.get("toy")
lemb = convert.laser2_from_numpy(convert.init_laser2_params(lcfg), lcfg, device="cpu")(
    [[5, 6, 7], [8, 1, 1]], [3, 1])
assert lemb.shape == (2, 48)
from sonar_tpu_torch.parallel import cosine_topk, mine_bitexts, xsim, xsim_pp
bank = rng.standard_normal((40, 16)).astype(np.float32)
scores, idx = cosine_topk(bank[:8], bank, 3, block_size=16, dot_dtype="int8", device="cpu")
assert (idx[:, 0].numpy() == np.arange(8)).all()
assert xsim(bank, bank, device="cpu") == 0.0
assert xsim_pp(bank, bank, rng.standard_normal((4, 16)), device="cpu") == 0.0
assert len(mine_bitexts(bank, bank, device="cpu")[0]) == 40
from sonar_tpu_torch.client import SonarClient
from sonar_tpu_torch.serving import EmbeddingServer
srv = EmbeddingServer(TextToEmbeddingModelPipeline(enc, tok, device="cpu"), max_wait_ms=1).start()
try:
    with SonarClient(*srv.address, timeout_s=60) as client:
        served = client.embed(["hello world", "the cat sat"])
finally:
    srv.stop()
assert np.array_equal(served, emb), (served, emb)

from sonar_tpu_torch.huggingface import HFTextToEmbeddingPipeline, HFTextToEmbeddingPipelineConfig
hf = HFTextToEmbeddingPipeline(HFTextToEmbeddingPipelineConfig(
    columns=["t"], encoder_model=enc, tokenizer=tok, device="cpu", sub_batch_size=5))
assert np.array_equal(np.asarray(hf.process_batch({"t": ["hello world", "the cat sat"]})["t_output"],
                                 np.float32), emb)

import torch
from sonar_tpu_torch.data.packing import pack_sequences
from sonar_tpu_torch.utils.flops import mfu
batch = next(pack_sequences([[5, 6, 7], [8, 9]], row_len=8, rows_per_batch=2, max_segments=2))
with torch.inference_mode():
    packed = enc.apply_packed(enc.params.tree(), *(torch.from_numpy(a) for a in (
        batch.tokens, batch.segment_ids, batch.positions)), batch.max_segments)
assert packed.shape == (2, 2, 32) and bool(torch.isfinite(packed).all()) and mfu(0.0) == 0.0

from sonar_tpu_torch.training import (
    init_train_state, make_train_step, restore_train_state, save_train_state, translation_loss)
tree = {"encoder": convert.init_text_encoder_params(cfg, 1), "decoder": convert.init_text_decoder_params(dcfg, 1)}
tree = {k: convert.text_encoder_from_numpy(v, cfg).params.tree() if k == "encoder"
        else convert.text_decoder_from_numpy(v, dcfg).params.tree() for k, v in tree.items()}
state = init_train_state(tree, lambda leaves: torch.optim.AdamW(leaves, lr=1e-3, weight_decay=0.01))
ids = torch.tensor([[5, 6, 7, 8]] * 2)
tb = {"src_tokens": ids, "src_lens": torch.tensor([4, 2]), "tgt_in": ids, "tgt_out": ids,
      "tgt_lens": torch.tensor([4, 3])}
step = make_train_step(lambda p, b, g: translation_loss(enc, dec, p["encoder"], p["decoder"], b, g))
state, loss = step(state, tb, torch.Generator().manual_seed(0))
assert state.step == 1 and bool(torch.isfinite(loss))
save_train_state(Path(sys.argv[1]) / "train.pt", state)
assert restore_train_state(Path(sys.argv[1]) / "train.pt", state).step == 1

import torch.distributed as dist
from sonar_tpu_torch.inference_pipelines.text import TorchTextEncoder
from sonar_tpu_torch.parallel import initialize, make_mesh, sharded_cosine_topk
initialize("file://" + str(Path(sys.argv[1]) / "rendezvous"), rank=0, world_size=1, backend="gloo")
mesh = make_mesh(1, 1)
memb = TextToEmbeddingModelPipeline(TorchTextEncoder(enc, device="cpu", mesh=mesh), tok,
                                    device="cpu").predict(["hello world", "the cat sat"],
                                                          source_lang="eng_Latn")
assert np.array_equal(memb, emb), (memb, emb)
want = cosine_topk(bank[:8], bank, 3, dot_dtype="int8", device="cpu")
got = sharded_cosine_topk(bank[:8], bank, 3, mesh, dot_dtype="int8", device="cpu")
assert all(torch.equal(a, b) for a, b in zip(got, want))
from sonar_tpu_torch.parallel import (
    make_pipeline_mesh, make_seq_mesh, pipeline_text_encode, sequence_speech_encode)
with torch.no_grad():
    lens = torch.tensor([4, 2])
    assert torch.equal(pipeline_text_encode(enc, enc.params.tree(), ids, lens,
                                            mesh=make_pipeline_mesh(1)),
                       enc(ids, lens).sentence_embeddings)
    fb, fl = torch.from_numpy(rng.standard_normal((2, 40, 8)).astype(np.float32)), torch.tensor([40, 30])
    assert torch.equal(sequence_speech_encode(senc, senc.params.tree(), fb, fl,
                                              mesh=make_seq_mesh(1)).sentence_embeddings,
                       senc(fb, fl).sentence_embeddings)
dist.destroy_process_group()

loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "sonar_tpu", "datasets")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("ok")
"""


def test_port_runs_with_jax_and_sonar_tpu_blocked(tmp_path):
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_port_file_imports_jax_or_sonar_tpu(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "sonar_tpu"}


def test_scan_sees_an_import(tmp_path):
    """The scan catches both import forms, also inside a function."""
    src = tmp_path / "m.py"
    src.write_text("def f():\n    from sonar_tpu.data import collate\n    import jax.numpy\n"
                   "from sonar_tpu_torch.ops import topk\n")
    assert _imported_roots(src) == {"sonar_tpu", "jax", "sonar_tpu_torch"}


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_gpu(no_gpu):
    """``device=None`` means ``cuda``: without a GPU each entry point raises
    before it runs anything, and ``device="cpu"`` is what the CPU needs."""
    from sonar_tpu_torch.assets import convert, hub
    from sonar_tpu_torch.data.collate import SequenceBatch
    from sonar_tpu_torch.device import resolve_device
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.inference_pipelines import speech, text
    from sonar_tpu_torch.inference_pipelines.mutox_speech import MutoxSpeechClassifierPipeline
    from sonar_tpu_torch.models import blaser, laser2_text, mutox
    from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs, sonar_text_encoder_archs
    from sonar_tpu_torch.huggingface import audio as hf_audio, text as hf_text
    from sonar_tpu_torch.parallel import mining

    tcfg = sonar_text_encoder_archs.get("toy")
    tenc = convert.text_encoder_from_numpy(convert.init_text_encoder_params(tcfg, 0), tcfg)
    scfg = sonar_speech_encoder_archs.get("toy")
    senc = convert.speech_encoder_from_numpy(convert.init_speech_encoder_params(scfg, 0), scfg)
    dcfg = sonar_text_decoder_archs.get("toy")
    dec = convert.text_decoder_from_numpy(convert.init_text_decoder_params(dcfg, 0), dcfg)
    bcfg = blaser.blaser_archs.get("basic_qe")
    mcfg = mutox.MutoxConfig(32)
    lcfg = laser2_text.laser2_archs.get("toy")
    calls = [
        lambda: text.TorchTextEncoder(tenc),
        lambda: speech.TorchSpeechEncoder(senc),
        lambda: TorchTextDecoder(dec),
        lambda: text.TextToEmbeddingModelPipeline(tenc, tokenizer=None),
        lambda: speech.SpeechToEmbeddingModelPipeline(senc),
        lambda: speech.SpeechToEmbeddingPipeline(senc),
        lambda: text.EmbeddingToTextModelPipeline(dec, tokenizer=None),
        lambda: text.TextToTextModelPipeline(tenc, dec, tokenizer=None),
        lambda: hub.load_text_encoder("text_sonar_basic_encoder"),
        lambda: hub.load_speech_encoder("sonar_speech_encoder_eng"),
        lambda: hub.load_text_decoder("text_sonar_basic_decoder"),
        lambda: speech.SpeechToTextModelPipeline(senc, dec, tokenizer=None),
        lambda: speech.SpeechToTextPipeline((senc, dec), tokenizer=None),
        lambda: MutoxSpeechClassifierPipeline("sonar_mutox", senc),
        lambda: hub.load_blaser_model("blaser_2_0_qe"),
        lambda: hub.load_mutox_model("sonar_mutox"),
        lambda: hub.load_laser2_model("laser2_text_encoder"),
        lambda: convert.blaser_from_numpy(convert.init_blaser_params(bcfg), bcfg),
        lambda: convert.mutox_from_numpy(convert.init_mutox_params(mcfg), mcfg),
        lambda: convert.laser2_from_numpy(convert.init_laser2_params(lcfg), lcfg),
        lambda: mining.cosine_topk(np.ones((2, 4)), np.ones((3, 4)), 1),
        lambda: mining.xsim(np.ones((2, 4)), np.ones((2, 4))),
        lambda: mining.xsim_pp(np.ones((2, 4)), np.ones((2, 4)), np.ones((1, 4))),
        lambda: mining.mine_bitexts(np.ones((2, 4)), np.ones((2, 4))),
        lambda: hf_text.HFTextToEmbeddingPipeline(hf_text.HFTextToEmbeddingPipelineConfig(
            encoder_model=tenc, tokenizer=None)),
        lambda: hf_text.HFEmbeddingToTextPipeline(hf_text.HFEmbeddingToTextPipelineConfig(
            decoder_model=dec, tokenizer=None)),
        lambda: hf_audio.HFAudioToEmbeddingPipeline(hf_audio.HFAudioToEmbeddingPipelineConfig(
            encoder_model=senc)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    assert TorchTextDecoder(dec, device="cpu").device == torch.device("cpu")
    enc = text.TorchTextEncoder(tenc, device="cpu")
    emb = enc.encode_batch(SequenceBatch(seqs=np.full((1, 4), 5, np.int32),
                                         seq_lens=np.asarray([4], np.int32), true_batch=1))
    assert enc.device == torch.device("cpu") and emb.shape == (1, 32)
