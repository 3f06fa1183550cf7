"""The port's (data, model) mesh on the encoders, against ``sonar_tpu``.

One gloo world of 4 ranks (``tests/torch_port_mesh_worker.py``) runs every
case on the meshes (2, 2), (4, 1) and (1, 4); this process computes JAX's
results (on its 8 virtual CPU devices, at JAX's own (4, 2) mesh where the
JAX test does) and the single-device port's. Every rank returns the whole
result, and each rank's is held against both:

- the toy encoder of ``tests/unit/test_parallel.py`` (D 64, 4 heads, FFN
  256): fp32 and int8 within atol 2e-4;
- ``TextToEmbeddingModelPipeline`` over ``TorchTextEncoder(mesh=)``, atol
  2e-4 (the toy tokenizer's odd vocabulary stays whole on every mesh);
- the toy speech encoder, atol 2e-4;
- a row-parallel int8 projection whose row maximum lies in one rank's
  slice: the absmax agreed over the model group gives the single-device
  result within 2e-4, a per-slice absmax gives one outside it;
- the split rules: the FFN is split, the LayerNorms are whole, the fused
  ``qkv_proj`` is split by head (q | k | v of the rank's heads).
"""

import dataclasses
from pathlib import Path
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent.parent))
from helpers import build_toy_nllb, build_toy_spm_proto  # noqa: E402
from torch_port_mesh_worker import LAYOUTS, run_world  # noqa: E402

from sonar_tpu.data.collate import SequenceBatch as JaxBatch  # noqa: E402
from sonar_tpu.inference_pipelines.speech import JitSpeechEncoder  # noqa: E402
from sonar_tpu.inference_pipelines.text import JitTextEncoder  # noqa: E402
from sonar_tpu.inference_pipelines.text import (  # noqa: E402
    TextToEmbeddingModelPipeline as JaxPipeline,
)
from sonar_tpu.models.sonar_speech import SonarSpeechEncoder, sonar_speech_encoder_archs  # noqa: E402
from sonar_tpu.models.sonar_text import SonarTextEncoder, sonar_text_encoder_archs  # noqa: E402
from sonar_tpu.ops.fbank import FbankConfig as JaxFbankConfig  # noqa: E402
from sonar_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from sonar_tpu_torch.assets.checkpoint import save_params  # noqa: E402
from sonar_tpu_torch.assets.convert import (  # noqa: E402
    speech_encoder_from_numpy,
    text_encoder_from_numpy,
)
from sonar_tpu_torch.data.collate import SequenceBatch  # noqa: E402
from sonar_tpu_torch.inference_pipelines.speech import TorchSpeechEncoder  # noqa: E402
from sonar_tpu_torch.inference_pipelines.text import (  # noqa: E402
    TextToEmbeddingModelPipeline,
    TorchTextEncoder,
)
from sonar_tpu_torch.models.sonar_speech import (  # noqa: E402
    sonar_speech_encoder_archs as port_speech_archs,
)
from sonar_tpu_torch.models.sonar_text import (  # noqa: E402
    sonar_text_encoder_archs as port_text_archs,
)
from sonar_tpu_torch.ops.fbank import FbankConfig  # noqa: E402
from sonar_tpu_torch.ops.quantization import int8_linear, quantize_kernel  # noqa: E402
from sonar_tpu_torch.parallel.comm import SINGLE  # noqa: E402
from sonar_tpu_torch.parallel.mesh import Mesh, param_shardings  # noqa: E402
from sonar_tpu_torch.tokenizers.nllb import NllbTokenizer  # noqa: E402
from sonar_tpu_torch.tokenizers.spm_proto import serialize_model_proto  # noqa: E402

ATOL = 2e-4
NAMES = [f"{d}x{m}" for d, m in LAYOUTS]
SENTENCES = ["hello world", "my name is paul", "the cat sat", "hello", "world"]


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _cfg(vocab_size=None):
    cfg = dataclasses.replace(sonar_text_encoder_archs.get("toy"), model_dim=64,
                              ffn_inner_dim=256, num_encoder_attn_heads=4)
    if vocab_size is not None:
        cfg = dataclasses.replace(cfg, vocab_info=dataclasses.replace(cfg.vocab_info,
                                                                      size=vocab_size))
    return cfg


def _port_cfg(cfg):
    return dataclasses.replace(port_text_archs.get("toy"), model_dim=cfg.model_dim,
                               ffn_inner_dim=cfg.ffn_inner_dim,
                               num_encoder_attn_heads=cfg.num_encoder_attn_heads,
                               vocab_info=dataclasses.replace(
                                   port_text_archs.get("toy").vocab_info,
                                   size=cfg.vocab_info.size))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_encode")
    rng = np.random.default_rng(0)
    cfg = _cfg()
    enc_np = _np_tree(SonarTextEncoder(cfg).init_params(jax.random.PRNGKey(0)))
    seqs = rng.integers(4, 1000, size=(8, 12)).astype(np.int32)
    lens = np.asarray([12, 9, 12, 5, 12, 12, 7, 12], np.int32)

    jax_tok = build_toy_nllb(tmp)
    (tmp / "tok.model").write_bytes(serialize_model_proto(build_toy_spm_proto()))
    pipe_cfg = _cfg(len(jax_tok.model))
    pipe_np = _np_tree(SonarTextEncoder(pipe_cfg).init_params(jax.random.PRNGKey(0)))
    speech_model = SonarSpeechEncoder(sonar_speech_encoder_archs.get("toy"))
    speech_np = _np_tree(speech_model.init_params(jax.random.PRNGKey(0)))
    waves = [(rng.normal(size=8000) * 0.1).astype(np.float32) for _ in range(3)]

    # The row-parallel int8 case: the largest value of each row in the
    # first quarter of the input axis (model rank 0's slice at model 2 and 4).
    x = rng.uniform(-1, 1, (4, 64)).astype(np.float32)
    x[:, 3] = 40.0
    w = rng.normal(size=(64, 32)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    qkv = rng.normal(size=(64, 192)).astype(np.float32)

    data = {"seqs": seqs, "lens": lens, "tok_vocab": np.asarray(len(jax_tok.model)),
            "sentences": np.asarray(SENTENCES), "absmax_x": x, "absmax_w": w, "absmax_b": b,
            "qkv": qkv, **{f"wave{i}": wv for i, wv in enumerate(waves)}}
    save_params(tmp / "inputs.npz", {"encoder": enc_np, "pipe_encoder": pipe_np,
                                   "speech": speech_np, "data": data})
    ranks = run_world("encode", 4, tmp)

    # JAX: single device, and the fp32 / int8 encodes at its (4, 2) mesh.
    model = SonarTextEncoder(cfg)
    jbatch = JaxBatch(seqs=seqs, seq_lens=lens, true_batch=8)
    jax_ref = {f"{q}": JitTextEncoder(model, enc_np, quantize=q == "int8").encode_batch(jbatch)
               for q in ("fp32", "int8")}
    mesh = jax_make_mesh(data=4, model=2)
    with mesh:
        jax_mesh = {f"{q}": JitTextEncoder(model, enc_np, quantize=q == "int8", mesh=mesh)
                    .encode_batch(jbatch) for q in ("fp32", "int8")}
    jax_ref["pipeline"] = JaxPipeline(encoder=JitTextEncoder(SonarTextEncoder(pipe_cfg), pipe_np),
                                      tokenizer=jax_tok).predict(
        SENTENCES, source_lang="eng_Latn", batch_size=3)
    jax_ref["speech"] = JitSpeechEncoder(speech_model, speech_np, fbank_config=JaxFbankConfig(
        num_mel_bins=8)).encode_waveforms(waves)

    # The single-device port.
    port_enc = text_encoder_from_numpy(enc_np, _port_cfg(cfg))
    batch = SequenceBatch(seqs=seqs, seq_lens=lens, true_batch=8)
    port = {q: TorchTextEncoder(port_enc, quantize=q == "int8", device="cpu").encode_batch(batch)
            for q in ("fp32", "int8")}
    tok = NllbTokenizer(tmp / "tok.model", langs=["eng_Latn", "fra_Latn"],
                        default_lang="eng_Latn")
    port["pipeline"] = TextToEmbeddingModelPipeline(TorchTextEncoder(text_encoder_from_numpy(
        pipe_np, _port_cfg(pipe_cfg)), device="cpu"), tok).predict(
        SENTENCES, source_lang="eng_Latn", batch_size=3)
    port["speech"] = TorchSpeechEncoder(speech_encoder_from_numpy(
        speech_np, port_speech_archs.get("toy")), fbank_config=FbankConfig(num_mel_bins=8),
        device="cpu").encode_waveforms(waves)
    kq, scale = quantize_kernel(torch.from_numpy(w))
    port["absmax"] = int8_linear({"kernel_q": kq, "scale": scale, "bias": torch.from_numpy(b)},
                                 torch.from_numpy(x)).numpy()
    return {"ranks": ranks, "jax": jax_ref, "jax_mesh": jax_mesh, "port": port,
            "qkv": qkv, "enc": port_enc}


def _each_rank(world, key):
    for rank, out in enumerate(world["ranks"]):
        for part in key.split("/"):
            out = out[part]
        yield rank, out


@pytest.mark.parametrize("name", NAMES)
def test_tp_dp_forward_matches_single_device(world, name):
    for rank, got in _each_rank(world, f"{name}/fp32"):
        np.testing.assert_allclose(got, world["jax_mesh"]["fp32"], atol=ATOL, err_msg=str(rank))
        np.testing.assert_allclose(got, world["jax"]["fp32"], atol=ATOL)
        np.testing.assert_allclose(got, world["port"]["fp32"], atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_sharded_int8_encode_matches_single_device(world, name):
    for rank, got in _each_rank(world, f"{name}/int8"):
        np.testing.assert_allclose(got, world["jax_mesh"]["int8"], atol=ATOL, err_msg=str(rank))
        np.testing.assert_allclose(got, world["jax"]["int8"], atol=ATOL)
        # The int32 sums of the row-parallel products are summed exactly.
        np.testing.assert_allclose(got, world["port"]["int8"], atol=ATOL)


@pytest.mark.parametrize("name", ["2x2", "1x4"])
def test_row_parallel_int8_takes_the_row_absmax_over_the_model_group(world, name):
    want = world["port"]["absmax"]
    for rank, got in _each_rank(world, f"{name}/absmax"):
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=str(rank))
    # The slice-local absmax computes another function: outside the tolerance.
    for rank, wrong in _each_rank(world, f"{name}/absmax_local"):
        assert np.abs(wrong - want).max() > 100 * ATOL, rank


@pytest.mark.parametrize("name", NAMES)
def test_mesh_sharded_pipeline_encode(world, name):
    for rank, got in _each_rank(world, f"{name}/pipeline"):
        np.testing.assert_allclose(got, world["jax"]["pipeline"], atol=ATOL, err_msg=str(rank))
        np.testing.assert_allclose(got, world["port"]["pipeline"], atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_sharded_speech_encode(world, name):
    for rank, got in _each_rank(world, f"{name}/speech"):
        np.testing.assert_allclose(got, world["jax"]["speech"], atol=ATOL, err_msg=str(rank))
        np.testing.assert_allclose(got, world["port"]["speech"], atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_fused_qkv_splits_by_head(world, name):
    """Rank (d, m) holds the q | k | v columns of heads m*H/n .. (m+1)*H/n."""
    qkv = world["qkv"]
    d, n = (int(v) for v in name.split("x"))
    third = qkv.shape[1] // 3
    width = third // n
    for rank, got in _each_rank(world, f"{name}/qkv_local"):
        m = rank % n
        want = np.concatenate([qkv[:, j * third + m * width:j * third + (m + 1) * width]
                               for j in range(3)], axis=1)
        np.testing.assert_array_equal(got, want)


def test_param_shardings_split_ffn(world):
    params = world["enc"].params.tree()
    mesh = Mesh(data=4, model=2, rank=0, data_group=SINGLE, model_group=SINGLE, world=SINGLE)
    sh = param_shardings(params, mesh)
    assert sh["encoder"]["layers"]["ffn"]["inner_proj"]["kernel"][-1] == "model"
    assert sh["encoder"]["layers"]["ffn"]["output_proj"]["kernel"][-2] == "model"
    assert sh["encoder"]["layers"]["ffn"]["output_proj"]["bias"] == ()
    assert sh["layer_norm"]["weight"] == ()
    assert sh["encoder_frontend"]["embed"]["weight"] == ("model", None)


def test_shard_params_keeps_an_odd_vocabulary_whole_and_refuses_an_odd_ffn():
    """JAX's fallback for the vocabulary (NLLB's 256,206 at model 4: 1022 at
    model 4 here); an FFN whose width does not divide raises, since a layer
    could not tell a whole pair from a split one."""
    from sonar_tpu_torch.parallel.mesh import shard_params

    mesh = Mesh(data=1, model=4, rank=1, data_group=SINGLE, model_group=SINGLE, world=SINGLE)
    table = torch.arange(1022.0)[:, None]
    local = shard_params({"decoder_frontend": {"embed": {"weight": table}}}, mesh)
    assert local["decoder_frontend"]["embed"]["weight"] is table
    two = Mesh(data=1, model=2, rank=1, data_group=SINGLE, model_group=SINGLE, world=SINGLE)
    half = shard_params({"decoder_frontend": {"embed": {"weight": table}}}, two)
    assert torch.equal(half["decoder_frontend"]["embed"]["weight"], table[511:])
    with pytest.raises(ValueError, match="does not split over model=4"):
        shard_params({"ffn": {"inner_proj": {"kernel": torch.zeros(8, 6)}}}, mesh)
