"""The port's mesh-sharded training against ``jax.value_and_grad``.

One gloo world of 4 ranks (``tests/torch_port_mesh_worker.py``) takes the
steps; this process computes JAX's loss and gradients on the global batch
and the single-device port's steps. Every rank's leaves are its
``shard_params`` slices, so JAX's gradient leaves are sliced the same way
before they are compared. Tolerances are ``test_torch_port_training.py``'s:
the loss within 1e-5 relative, every gradient leaf within 1e-4 of its scale
(the max-abs of JAX's whole leaf, floored at a thousandth of the largest).

- one step of ``translation_loss`` at (2, 2) and (4, 1) on a global batch
  whose data ranks hold different valid-token counts; and the variant that
  averages each rank's local token mean, which must miss the tolerance;
- three AdamW steps at (2, 2) against the single-device port (1e-5 of each
  leaf's scale);
- a step with dropout on at (2, 2) and (1, 4): every rank ends with the
  same replicated leaves, bit for bit;
- ``classifier_loss`` with a frozen encoder (its leaves get no gradient and
  join no collective) and ``distillation_loss`` on the toy Conformer, at
  (2, 2).
"""

from pathlib import Path
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent.parent))
from torch_port_mesh_worker import TEXT_KEYS, run_world  # noqa: E402

from sonar_tpu.models.mutox.model import MutoxClassifier as JaxMutox, MutoxConfig  # noqa: E402
from sonar_tpu.models.sonar_speech import config as jspeech_cfg  # noqa: E402
from sonar_tpu.models.sonar_speech.model import SonarSpeechEncoder as JaxSpeech  # noqa: E402
from sonar_tpu.models.sonar_text import SonarTextEncoder as JaxEncoder  # noqa: E402
from sonar_tpu.models.sonar_text.config import sonar_text_decoder_archs as jdec  # noqa: E402
from sonar_tpu.models.sonar_text.config import sonar_text_encoder_archs as jenc  # noqa: E402
from sonar_tpu.nn.conditional_decoder import ConditionalTransformerDecoder as JaxDecoder  # noqa: E402
from sonar_tpu.training import train_step as jts  # noqa: E402
from sonar_tpu_torch.assets.checkpoint import flatten_params, save_params  # noqa: E402
from sonar_tpu_torch.assets.convert import (  # noqa: E402
    text_decoder_from_numpy,
    text_encoder_from_numpy,
)
from sonar_tpu_torch.models.sonar_text import (  # noqa: E402
    sonar_text_decoder_archs,
    sonar_text_encoder_archs,
)
from sonar_tpu_torch.parallel.comm import SINGLE  # noqa: E402
from sonar_tpu_torch.parallel.mesh import Mesh, shard_params  # noqa: E402
from sonar_tpu_torch.training import train_step as ts  # noqa: E402


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32) if np.asarray(a).dtype.kind
                                  == "f" else np.array(a), tree)


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.tensor(np.array(v))
            for k, v in tree.items()}


def _jax_batch(data, keys):
    return {k: jnp.asarray(data[k]) for k in keys}


def _rank_mesh(name, rank):
    """A mesh of the layout ``name`` as rank ``rank`` sees it, for slicing."""
    d, m = (int(v) for v in name.split("x"))
    return Mesh(data=d, model=m, rank=rank, data_group=SINGLE, model_group=SINGLE, world=SINGLE)


def _sliced(tree, name, rank):
    return flatten_params(shard_params(_torch_tree(tree), _rank_mesh(name, rank)))


def _grad_error(got, want, name, rank, skip=()):
    """The largest error of a rank's gradient leaves over their tolerance
    (<= 1 passes)."""
    whole = flatten_params(want)
    floor = 1e-3 * max(np.abs(w).max() for w in whole.values())
    local = _sliced(want, name, rank)
    worst = 0.0
    for path, w in local.items():
        if path in skip:
            continue
        scale = max(np.abs(whole[path]).max(), floor)
        worst = max(worst, np.abs(got[path] - w).max() / (1e-4 * scale))
    return worst


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    enc = _np_tree(JaxEncoder(jenc.get("toy")).init_params(jax.random.PRNGKey(0)))
    dec = _np_tree(JaxDecoder(jdec.get("toy")).init_params(jax.random.PRNGKey(1)))
    head = _np_tree(JaxMutox(MutoxConfig(input_size=32)).init_params(jax.random.PRNGKey(2)))
    jspeech = JaxSpeech(jspeech_cfg.sonar_speech_encoder_archs.get("toy"))
    speech = _np_tree(jspeech.init_params(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(0)
    data = {
        "src_tokens": rng.integers(4, 1000, (8, 8)).astype(np.int32),
        "src_lens": np.array([8, 5, 8, 3, 7, 8, 2, 6], np.int32),
        "tgt_in": rng.integers(4, 1000, (8, 6)).astype(np.int32),
        "tgt_out": rng.integers(4, 1000, (8, 6)).astype(np.int32),
        # 23 valid tokens in the first half, 5 in the second; 12, 11, 3, 2 by quarter.
        "tgt_lens": np.array([6, 6, 6, 5, 1, 2, 1, 1], np.int32),
        "tokens": rng.integers(4, 1000, (8, 8)).astype(np.int32),
        "lens": np.array([8, 3, 8, 6, 1, 8, 7, 5], np.int32),
        "labels": rng.integers(0, 2, (8,)).astype(np.int32),
        "inputs": rng.normal(size=(8, 20, 8)).astype(np.float32),
        "teacher_emb": rng.normal(size=(8, 32)).astype(np.float32),
    }
    frame_lens = np.array([20, 16, 12, 20, 8, 20, 18, 10], np.int32)
    save_params(tmp / "inputs.npz", {"encoder": enc, "decoder": dec, "head": head,
                                   "speech": speech, "data": {**data, "frame_lens": frame_lens}})
    ranks = run_world("train", 4, tmp)

    je, jd = JaxEncoder(jenc.get("toy")), JaxDecoder(jdec.get("toy"))
    jb = _jax_batch(data, TEXT_KEYS)
    loss, grads = jax.value_and_grad(lambda p: jts.translation_loss(
        je, jd, p["encoder"], p["decoder"], jb))({"encoder": enc, "decoder": dec})
    cls_loss, cls_grads = jax.value_and_grad(lambda p: jts.classifier_loss(
        je, JaxMutox(MutoxConfig(input_size=32)), p, _jax_batch(data, ("tokens", "lens", "labels")),
        freeze_encoder=True))({"encoder": enc, "head": head})
    dist_loss, dist_grads = jax.value_and_grad(lambda p: jts.distillation_loss(
        jspeech, p, {"inputs": jnp.asarray(data["inputs"]), "lens": jnp.asarray(frame_lens),
                     "teacher_emb": jnp.asarray(data["teacher_emb"])}))(speech)

    encoder = text_encoder_from_numpy(enc, sonar_text_encoder_archs.get("toy"))
    decoder = text_decoder_from_numpy(dec, sonar_text_decoder_archs.get("toy"))
    state = ts.init_train_state(_torch_tree({"encoder": enc, "decoder": dec}),
                                lambda leaves: torch.optim.AdamW(
                                    leaves, lr=3e-3, betas=(0.8, 0.95), eps=1e-4,
                                    weight_decay=0.05))
    step = ts.make_train_step(lambda p, b, g: ts.translation_loss(
        encoder, decoder, p["encoder"], p["decoder"], b, g))
    batch = {k: torch.tensor(data[k]) for k in TEXT_KEYS}
    for _ in range(3):
        state, _ = step(state, batch)
    adamw = flatten_params(state.params)
    return {"ranks": ranks, "loss": float(loss), "grads": _np_tree(grads),
            "cls_loss": float(cls_loss), "cls_grads": _np_tree(cls_grads),
            "dist_loss": float(dist_loss), "dist_grads": _np_tree(dist_grads),
            "adamw": adamw}


@pytest.mark.parametrize("name", ["2x2", "4x1"])
def test_step_loss_and_grads_match_jax_on_the_global_batch(world, name):
    for rank, out in enumerate(world["ranks"]):
        np.testing.assert_allclose(float(out[name]["loss"]), world["loss"], rtol=1e-5)
        got = flatten_params(out[name]["grads"])
        assert _grad_error(got, world["grads"], name, rank) <= 1.0, rank


def test_local_token_means_miss_the_global_mean(world):
    """The ranks hold 12, 11, 3 and 2 valid tokens: their local means,
    averaged, give other gradients (far outside the tolerance)."""
    for rank, out in enumerate(world["ranks"]):
        got = flatten_params(out["4x1"]["grads_local_means"])
        assert _grad_error(got, world["grads"], "4x1", rank) > 10.0, rank


def test_three_adamw_steps_match_the_single_device_port(world):
    want = world["adamw"]
    for rank, out in enumerate(world["ranks"]):
        got = flatten_params(out["2x2"]["adamw"])
        local = _sliced({k: v for k, v in want.items()}, "2x2", rank)
        assert got.keys() == local.keys()
        for path, w in local.items():
            err = np.abs(got[path] - w).max()
            assert err <= 1e-5 * max(np.abs(want[path]).max(), 1e-30), (rank, path, err)


@pytest.mark.parametrize("name", ["2x2", "1x4"])
def test_dropout_keeps_replicated_leaves_identical_across_ranks(world, name):
    first = flatten_params(world["ranks"][0][name]["dropout_replicated"])
    assert first
    for rank, out in enumerate(world["ranks"][1:], start=1):
        assert float(out[name]["dropout_loss"]) == float(world["ranks"][0][name]["dropout_loss"])
        got = flatten_params(out[name]["dropout_replicated"])
        for path, w in first.items():
            np.testing.assert_array_equal(got[path], w, err_msg=f"{rank} {path}")


def test_frozen_encoder_takes_no_gradient_and_no_collective(world):
    for rank, out in enumerate(world["ranks"]):
        np.testing.assert_allclose(float(out["frozen"]["loss"]), world["cls_loss"], rtol=1e-5)
        got = flatten_params(out["frozen"]["grads"])
        frozen = [p for p in got if p.startswith("encoder/")]
        assert frozen and all(got[p].size == 0 for p in frozen)
        head = {p: g for p, g in got.items() if p.startswith("head/")}
        want = {"head": world["cls_grads"]["head"]}
        assert _grad_error(head, want, "2x2", rank) <= 1.0, rank


def test_distillation_on_the_conformer_matches_jax(world):
    for rank, out in enumerate(world["ranks"]):
        np.testing.assert_allclose(float(out["distill"]["loss"]), world["dist_loss"], rtol=1e-5)
        got = flatten_params(out["distill"]["grads"])
        assert _grad_error(got, world["dist_grads"], "2x2", rank) <= 1.0, rank
