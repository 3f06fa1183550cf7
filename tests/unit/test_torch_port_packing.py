"""The port's packed text encoding against ``sonar_tpu``'s, on the CPU.

- ``pack_sequences`` gives JAX's batches array for array and mapping for
  mapping;
- ``SonarTextEncoder.apply_packed`` against JAX's ``apply_packed`` on the
  same numpy weights and batches: on ``toy`` and on a D 128 / 2 x 64 config
  at row_len 32 and 128 (from 128 the full bias takes the flash attention
  wrapper, and 16 rows of 128 tokens take the int8 FFN's), every batch with
  rows that are padding from start to end. fp32 atol 2e-4, bf16 cosine >=
  0.9999 per filled slot, int8 cosine >= 0.999;
- packed against per-sentence encoding in the port, within JAX's own bound
  for the same check (2e-4, ``test_packing.py``).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sonar_tpu.data.packing import pack_sequences as jax_pack  # noqa: E402
from sonar_tpu.models.sonar_text import SonarTextEncoder as JaxEncoder  # noqa: E402
from sonar_tpu.models.sonar_text import sonar_text_encoder_archs as jax_archs  # noqa: E402
from sonar_tpu.nn.transformer import fuse_qkv as jax_fuse_qkv  # noqa: E402
from sonar_tpu.ops.quantization import quantize_params_int8 as jax_quantize  # noqa: E402
from sonar_tpu_torch.assets.convert import text_encoder_from_numpy  # noqa: E402
from sonar_tpu_torch.data.packing import PackedBatch, pack_sequences  # noqa: E402
from sonar_tpu_torch.inference_pipelines.text import TorchTextEncoder  # noqa: E402
from sonar_tpu_torch.models.sonar_text import sonar_text_encoder_archs  # noqa: E402
from sonar_tpu_torch.ops.cuda import ffn, flash  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "int8": (torch.float32, jnp.float32)}


def _sentences(seed, n, lo, hi, vocab=1000):
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi, size=n)
    return [list(map(int, rng.integers(4, vocab, size=int(k)))) for k in lens]


def _wide(archs):
    return dataclasses.replace(archs.get("toy"), model_dim=128, num_encoder_attn_heads=2,
                               ffn_inner_dim=512)


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("n,lo,hi,row_len,rows,segs", [
    (17, 3, 14, 16, 4, 4),
    (40, 1, 40, 32, 3, 8),
    (200, 2, 60, 128, 64, 16),
    (9, 20, 200, 128, 2, 2),  # longer than a row: truncated
    (1, 5, 6, 8, 4, 1),
], ids=["jax-test", "small-rows", "bench", "truncated", "one"])
def test_pack_sequences_matches_jax(n, lo, hi, row_len, rows, segs):
    sents = _sentences(n + row_len, n, lo, hi)
    got = list(pack_sequences(sents, row_len=row_len, rows_per_batch=rows, max_segments=segs))
    want = list(jax_pack(sents, row_len=row_len, rows_per_batch=rows, max_segments=segs))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert isinstance(g, PackedBatch)
        for field in ("tokens", "segment_ids", "positions"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field
        assert g.mapping == w.mapping and g.max_segments == w.max_segments


def test_pack_sequences_rejects_empty_sequence():
    with pytest.raises(ValueError, match="zero-length"):
        list(pack_sequences([[1, 2], []], row_len=8, rows_per_batch=2))


def _encoders(cfg_name, mode):
    jcfg = jax_archs.get("toy") if cfg_name == "toy" else _wide(jax_archs)
    tcfg = sonar_text_encoder_archs.get("toy") if cfg_name == "toy" else _wide(
        sonar_text_encoder_archs)
    params = jax.tree_util.tree_map(
        np.asarray, JaxEncoder(jcfg).init_params(jax.random.PRNGKey(3)))
    tdt, jdt = DTYPES[mode]
    jparams = params
    if mode == "int8":
        jparams = jax_quantize(jax_fuse_qkv(params))
    enc = TorchTextEncoder(text_encoder_from_numpy(params, tcfg, tdt), quantize=mode == "int8",
                           device="cpu")
    return JaxEncoder(jcfg, dtype=jdt), jparams, enc.model


def _packed(model, batch):
    with torch.inference_mode():
        return model.apply_packed(
            model.params.tree(), torch.from_numpy(batch.tokens),
            torch.from_numpy(batch.segment_ids), torch.from_numpy(batch.positions),
            batch.max_segments).numpy()


@pytest.mark.parametrize("cfg_name,mode,row_len,rows", [
    ("toy", "float32", 32, 4),
    ("wide", "float32", 32, 4),
    ("wide", "float32", 128, 4),
    ("wide", "bfloat16", 128, 4),
    ("wide", "int8", 128, 16),
])
def test_apply_packed_matches_jax(cfg_name, mode, row_len, rows, monkeypatch):
    jax_model, jparams, model = _encoders(cfg_name, mode)
    calls = []
    for mod, name in ((flash, "flash_attention_plain"), (ffn, "fused_ffn_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (calls.append(_n),
                                                                        _f(*a, **k))[1])
    sents = _sentences(7, 3 * rows + 5, 2, row_len // 2)
    batches = list(pack_sequences(sents, row_len=row_len, rows_per_batch=rows, max_segments=8))
    last = batches[-1]
    assert (last.segment_ids == 0).all(axis=1).any(), "no row of padding only"
    for batch in batches:
        got = _packed(model, batch)
        want = np.asarray(jax_model.apply_packed(
            jparams, jnp.asarray(batch.tokens), jnp.asarray(batch.segment_ids),
            jnp.asarray(batch.positions), batch.max_segments), np.float32)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.shape == (rows, 8, model.config.model_dim)
        assert np.isfinite(got).all()
        filled = np.zeros(got.shape[:2], bool)
        for _, row, seg in batch.mapping:
            filled[row, seg - 1] = True
        assert (got[~filled] == 0).all() and (want[~filled] == 0).all()
        if mode == "float32":
            np.testing.assert_allclose(got, want, atol=2e-4)
        else:
            assert _cos(got[filled], want[filled]).min() >= (0.9999 if mode == "bfloat16"
                                                             else 0.999)
    # From row_len 128 the block-diagonal bias takes the flash wrapper (its
    # plain version here), and 16 rows of 128 tokens the int8 FFN's.
    assert ("flash_attention_plain" in calls) == (row_len >= 128)
    assert ("fused_ffn_plain" in calls) == (mode == "int8")


def test_apply_packed_matches_per_sentence_encoding():
    _, _, model = _encoders("wide", "float32")
    sents = _sentences(11, 21, 3, 40)
    got = np.zeros((len(sents), 128), np.float32)
    for batch in pack_sequences(sents, row_len=128, rows_per_batch=4, max_segments=6):
        emb = _packed(model, batch)
        for orig, row, seg in batch.mapping:
            got[orig] = emb[row, seg - 1]
    for i, s in enumerate(sents):
        with torch.inference_mode():
            want = model(torch.tensor([s], dtype=torch.int32),
                         torch.tensor([len(s)], dtype=torch.int32)).sentence_embeddings
        np.testing.assert_allclose(got[i], want[0].numpy(), atol=2e-4)


def test_apply_packed_refuses_what_jax_refuses():
    tcfg = dataclasses.replace(sonar_text_encoder_archs.get("toy"), pooling="max")
    params = jax.tree_util.tree_map(
        np.asarray, JaxEncoder(jax_archs.get("toy")).init_params(jax.random.PRNGKey(0)))
    model = text_encoder_from_numpy(params, tcfg)
    batch = next(pack_sequences([[5, 6, 7]], row_len=8, rows_per_batch=1))
    with pytest.raises(NotImplementedError, match="MEAN"):
        _packed(model, batch)
