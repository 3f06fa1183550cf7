"""The port's decoder over a (data, model) mesh, against ``sonar_tpu``.

One gloo world of 4 ranks (``tests/torch_port_mesh_worker.py``) decodes on
the meshes (2, 2), (4, 1) and (1, 4); this process computes JAX's results
(single device, and beam search at JAX's own (4, 2) mesh) and the
single-device port's. The toy decoder has a 1022-row vocabulary: split in
two blocks of 511 at model 2 (a block count that does not itself divide,
as NLLB's 256,206 at model 2) and kept whole at model 4 (as 256,206 is).
Its EOS embedding lies along the mean decoder output, so some rows stop
early and others run to the limit: the ranks must agree on the exit.

- beam search: tokens and lengths identical, scores within 1e-4;
- top-p sampling with JAX's Gumbel draws: tokens and lengths identical,
  scores within 1e-5;
- teacher-forced ``score`` (the tied projection gathered over the model
  group): within 1e-5 of the single-device port and of JAX.
"""

import dataclasses
from pathlib import Path
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent.parent))
from torch_port_mesh_worker import LAYOUTS, run_world  # noqa: E402

from sonar_tpu.generation import sampling as jsampling  # noqa: E402
from sonar_tpu.generation.beam_search import BeamSearchConfig as JaxBeamConfig  # noqa: E402
from sonar_tpu.generation.decoder_runtime import JitTextDecoder  # noqa: E402
from sonar_tpu.models.sonar_text import sonar_text_decoder_archs as jax_archs  # noqa: E402
from sonar_tpu.nn.conditional_decoder import ConditionalTransformerDecoder as JaxDecoder  # noqa: E402
from sonar_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from sonar_tpu_torch.assets.checkpoint import save_params  # noqa: E402
from sonar_tpu_torch.assets.convert import text_decoder_from_numpy  # noqa: E402
from sonar_tpu_torch.generation import sampling  # noqa: E402
from sonar_tpu_torch.generation.beam_search import BeamSearchConfig  # noqa: E402
from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder  # noqa: E402
from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs  # noqa: E402

VOCAB = 1022
NAMES = [f"{d}x{m}" for d, m in LAYOUTS]
PREFIX = [3, 7]
GEN = 6


def _cfg(archs):
    toy = archs.get("toy")
    return dataclasses.replace(toy, vocab_info=dataclasses.replace(toy.vocab_info, size=VOCAB))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_decode")
    jcfg, tcfg = _cfg(jax_archs), _cfg(sonar_text_decoder_archs)
    params = jax.tree_util.tree_map(np.array, JaxDecoder(jcfg).init_params(
        jax.random.PRNGKey(1)))
    d = tcfg.model_dim
    rng = np.random.default_rng(6)
    memory = rng.normal(size=(8, 1, d)).astype(np.float32) * 2.0
    # EOS along the mean decoder output (as test_torch_port_sampling.py).
    seqs = np.full((8, 5), 7, np.int32)
    seqs[:, 0] = 3
    with torch.inference_mode():
        h = text_decoder_from_numpy(params, tcfg).decode(
            torch.tensor(seqs), None, torch.tensor(memory)).reshape(-1, d).mean(0).numpy()
    params["decoder_frontend"]["embed"]["weight"][3] = h / np.linalg.norm(h) * 1.4 * np.sqrt(d) / 4
    score_seqs = rng.integers(4, VOCAB, size=(8, 5)).astype(np.int32)
    score_lens = np.asarray([5, 3, 5, 1, 4, 5, 2, 5], np.int32)
    key = jax.random.PRNGKey(11)
    noise = np.stack([np.asarray(jax.random.gumbel(jax.random.fold_in(key, step), (8, VOCAB),
                                                   jnp.float32)) for step in range(GEN)])
    save_params(tmp / "inputs.npz", {"decoder": params, "data": {
        "vocab": np.asarray(VOCAB), "memory": memory, "prefix": np.asarray(PREFIX),
        "noise": noise, "seqs": score_seqs, "seq_lens": score_lens}})
    ranks = run_world("decode", 4, tmp)

    jrun = JitTextDecoder(JaxDecoder(jcfg), params, quantize=False)
    beam_cfg = JaxBeamConfig(beam_size=2, max_gen_len=GEN)
    jax_ref = {"beam": jrun.generate_beam(memory, PREFIX, beam_cfg),
               "sample": jrun.generate_sample(memory, PREFIX, jsampling.TopPSampler(p=0.9),
                                              max_gen_len=GEN, seed=11),
               "score": jrun.score(score_seqs, score_lens, memory)}
    mesh = jax_make_mesh(data=4, model=2)
    jax_ref["beam_mesh"] = JitTextDecoder(JaxDecoder(jcfg), params, quantize=False,
                                          mesh=mesh).generate_beam(memory, PREFIX, beam_cfg)
    trun = TorchTextDecoder(text_decoder_from_numpy(params, tcfg), device="cpu")
    port = {"beam": trun.generate_beam(memory, PREFIX, BeamSearchConfig(beam_size=2,
                                                                         max_gen_len=GEN)),
            "sample": trun.generate_sample(memory, PREFIX, sampling.TopPSampler(p=0.9),
                                           max_gen_len=GEN,
                                           noise=lambda step, shape: noise[step][:shape[0]]),
            "score": trun.score(score_seqs, score_lens, memory)}
    return {"ranks": ranks, "jax": jax_ref, "port": port}


def _rank_outputs(world, name, kind):
    for rank, out in enumerate(world["ranks"]):
        got = out[name]
        yield rank, tuple(got[f"{kind}_{k}"] for k in ("tokens", "scores", "lens"))


def test_some_rows_stop_early_and_some_run_to_the_limit(world):
    _, _, lens = world["port"]["sample"]
    assert lens.min() < GEN + 1 and lens.max() == GEN + 1, lens
    _, _, beam_lens = world["port"]["beam"]
    assert beam_lens.min() < GEN + 1, beam_lens


@pytest.mark.parametrize("name", NAMES)
def test_mesh_sharded_beam_decode_matches_single_device(world, name):
    for rank, (t, s, ln) in _rank_outputs(world, name, "beam"):
        for ref in ("jax", "jax_mesh", "port"):
            rt, rs, rl = world["jax"]["beam_mesh"] if ref == "jax_mesh" else world[ref]["beam"]
            np.testing.assert_array_equal(ln, rl, err_msg=f"{rank} {ref}")
            np.testing.assert_array_equal(t, rt, err_msg=f"{rank} {ref}")
            np.testing.assert_allclose(s, rs, atol=1e-4, err_msg=f"{rank} {ref}")


@pytest.mark.parametrize("name", NAMES)
def test_mesh_sharded_sampling_matches_single_device(world, name):
    for rank, (t, s, ln) in _rank_outputs(world, name, "sample"):
        for ref in ("jax", "port"):
            rt, rs, rl = world[ref]["sample"]
            np.testing.assert_array_equal(ln, rl, err_msg=f"{rank} {ref}")
            np.testing.assert_array_equal(t, rt, err_msg=f"{rank} {ref}")
            np.testing.assert_allclose(s, rs, atol=1e-5, err_msg=f"{rank} {ref}")


@pytest.mark.parametrize("name", NAMES)
def test_vocab_split_tied_projection(world, name):
    model = int(name.split("x")[1])
    for rank, out in enumerate(world["ranks"]):
        rows = int(out[name]["embed_rows"])
        assert rows == (VOCAB // 2 if model == 2 else VOCAB), (rank, rows)
        got = out[name]["score"]
        np.testing.assert_allclose(got, world["port"]["score"], atol=1e-5, err_msg=str(rank))
        np.testing.assert_allclose(got, world["jax"]["score"], atol=1e-4, err_msg=str(rank))
