"""The port's GPipe pipeline (``sonar_tpu_torch.parallel.pipeline``) against
the JAX package's, in one gloo world of 8 ranks.

The world (``tests/torch_port_mesh_worker.py``, suite ``pipeline``) runs
every case at once on (stage, data) meshes of (4, 2), (2, 4) and (8, 1);
this process computes JAX's result at JAX's own mesh on the 8 virtual CPU
devices, and the single-device port's stack run microbatch by microbatch
(one thread, as the ranks run). Every rank's output is held against both:

- JAX: fp32 atol 2e-4 (the toy parity bound); bf16 and int8 by the
  port's own bounds against JAX, cosine >= 0.9999 and >= 0.999 per token
  row (``test_torch_port_encoder.py``'s). JAX's 2e-2 for bf16 holds its
  pipeline to its own scan; the port's one-device bf16 stack already differs
  from JAX's by up to 0.0703 (rounding at other points, values up to 8),
  and the int8 row quantisation of the two packages may round a code apart;
- the port's plain stack on the same microbatches: equal to the bit (every
  stage runs the plain stack on its layers; the transfers and the merge are
  exact);
- gradients (``test_pp_grads_match_scan``'s loss, with and without remat),
  on the rank's own stage slice of every layer leaf and on the input: JAX's
  within JAX's bound, ``atol = 1e-3 * max(1, 1e-2 * max|g|)``; the
  one-device port's within 1e-4 of each leaf's scale
  (``grad_error`` of ``tests/torch_port_mesh_worker.py``).
"""

from pathlib import Path
import sys

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent.parent))
from torch_port_mesh_worker import PP_CASES, finish_world, grad_error, start_world  # noqa: E402

from sonar_tpu.models.sonar_speech import SonarSpeechEncoder as JaxSpeech  # noqa: E402
from sonar_tpu.models.sonar_speech import sonar_speech_encoder_archs as jspeech  # noqa: E402
from sonar_tpu.models.sonar_text import SonarTextEncoder as JaxText  # noqa: E402
from sonar_tpu.models.sonar_text import sonar_text_encoder_archs as jtext  # noqa: E402
from sonar_tpu.nn import conformer as jconf  # noqa: E402
from sonar_tpu.ops.quantization import quantize_params_int8 as jquantize  # noqa: E402
from sonar_tpu.parallel import pipeline as jpp  # noqa: E402
from sonar_tpu_torch.assets.checkpoint import (  # noqa: E402
    flatten_params,
    save_params,
    unflatten_params,
)
from sonar_tpu_torch.assets.convert import (  # noqa: E402
    speech_encoder_from_numpy,
    text_encoder_from_numpy,
)
from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs  # noqa: E402
from sonar_tpu_torch.models.sonar_text import sonar_text_encoder_archs  # noqa: E402
from sonar_tpu_torch.nn.conformer import ConformerConfig, conformer_stack  # noqa: E402
from sonar_tpu_torch.nn.transformer import encoder_stack  # noqa: E402
from sonar_tpu_torch.ops.quantization import quantize_params_int8  # noqa: E402

D, HEADS, ACT = 64, 4, "relu"
CONFORMER = dict(model_dim=64, num_layers=4, num_heads=4, ffn_inner_dim=128,
                 depthwise_kernel_size=7)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32) if np.asarray(a).dtype.kind
                                  == "f" else np.array(a), tree)


def _torch_tree(tree, dtype=None):
    def leaf(a):
        t = torch.tensor(np.array(a))
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    return {k: _torch_tree(v, dtype) if isinstance(v, dict) else leaf(v) for k, v in tree.items()}


def _text_cfg(layers, archs):
    return dataclasses.replace(archs.get("toy"), model_dim=D, ffn_inner_dim=256,
                               num_encoder_attn_heads=HEADS, num_encoder_layers=layers)


def _key_bias(rng, b, s):
    lens = rng.integers(4, s + 1, b)
    return np.where(np.arange(s)[None, None, None, :] < lens[:, None, None, None], 0.0,
                    -np.inf).astype(np.float32)


def _chunked(fn, n, *args):
    """``fn`` on each of ``n`` equal row chunks of ``args`` (None passes),
    concatenated: the plain stack run microbatch by microbatch."""
    parts = [a.chunk(n) if a is not None else [None] * n for a in args]
    return torch.cat([fn(*(p[i] for p in parts)) for i in range(n)])


def _inputs():
    rng = np.random.default_rng(0)
    data = {}
    for stage, d, m in PP_CASES:
        b = d * m * 2
        data[f"x_{stage}x{d}x{m}"] = rng.normal(size=(b, 12, D)).astype(np.float32)
        data[f"bias_{stage}x{d}x{m}"] = _key_bias(rng, b, 12)
    for name, seed, s in (("nobias", 1, 10), ("bf16", 7, 10), ("int8", 9, 10), ("grads", 3, 6)):
        data[f"x_{name}"] = np.random.default_rng(seed).normal(size=(8, s, D)).astype(np.float32)
    rng = np.random.default_rng(2)
    data["seqs"] = rng.integers(4, 1000, size=(16, 12)).astype(np.int32)
    data["lens"] = rng.integers(3, 13, size=(16,)).astype(np.int32)
    rng = np.random.default_rng(5)
    data["seqs8"] = rng.integers(4, 1000, size=(8, 10)).astype(np.int32)
    data["lens8"] = rng.integers(3, 11, size=(8,)).astype(np.int32)
    rng = np.random.default_rng(0)
    data["cx"] = rng.normal(size=(8, 12, D)).astype(np.float32)
    clens = rng.integers(6, 13, size=(8,))
    data["cmask"] = np.arange(12)[None, :] < clens[:, None]
    data["cbias"] = np.where(data["cmask"], 0.0, -np.inf).astype(np.float32)[:, None, None, :]
    data["conformer_cfg"] = {k: np.array(v) for k, v in CONFORMER.items()}
    rng = np.random.default_rng(2)
    data["fbank"] = rng.normal(size=(8, 40, 8)).astype(np.float32)  # the toy's 8 mel bins
    data["frame_lens"] = rng.integers(20, 41, size=(8,)).astype(np.int32)
    return data


def _jax_refs(params, data):
    j = {k: jnp.asarray(v) for k, v in data.items() if k != "conformer_cfg"}
    text_model = JaxText(_text_cfg(4, jtext))
    layers = {n: params[f"layers{n}"] for n in (4, 8)}
    mesh = lambda s, d: jpp.make_pipeline_mesh(stage=s, data=d)  # noqa: E731
    out = {}
    for stage, d, m in PP_CASES:
        key = f"{stage}x{d}x{m}"
        out[f"stack_{key}"] = jpp.pipeline_encoder_stack(
            layers[8 if stage == 8 else 4], j[f"x_{key}"], j[f"bias_{key}"], HEADS, ACT,
            mesh(stage, d), num_microbatches=m)
    out["nobias"] = jpp.pipeline_encoder_stack(layers[4], j["x_nobias"], None, HEADS, ACT,
                                               mesh(4, 2), num_microbatches=4)
    out["bf16"] = jpp.pipeline_encoder_stack(
        jax.tree.map(lambda a: a.astype(jnp.bfloat16), layers[4]),
        j["x_bf16"].astype(jnp.bfloat16), None, HEADS, ACT, mesh(4, 2), num_microbatches=4)
    out["int8"] = jpp.pipeline_encoder_stack(jquantize(layers[4]), j["x_int8"], None, HEADS, ACT,
                                             mesh(4, 2), num_microbatches=4)
    for remat in (False, True):
        def loss(p, xx, remat=remat):
            return jnp.sum(jpp.pipeline_encoder_stack(
                p, xx, None, HEADS, ACT, mesh(4, 2), num_microbatches=4, remat=remat) ** 2)

        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(layers[4], j["x_grads"])
        out[f"grads_remat{int(remat)}"] = {"params": gp, "x": gx}
    placed = jax.device_put(params["text"], jpp.pipeline_param_shardings(params["text"],
                                                                         mesh(4, 2)))
    out["text_encode"] = jpp.pipeline_text_encode(text_model, placed, j["seqs"], j["lens"],
                                                  mesh=mesh(4, 2), num_microbatches=4)
    out["default_m"] = jpp.pipeline_text_encode(text_model, params["text"], j["seqs8"],
                                                j["lens8"], mesh=mesh(2, 4))
    ccfg = jconf.ConformerConfig(**CONFORMER)
    out["conformer"] = jpp.pipeline_conformer_stack(params["conformer"], j["cx"], j["cbias"],
                                                    j["cmask"], ccfg, mesh(4, 2),
                                                    num_microbatches=4)
    speech = JaxSpeech(jspeech.get("toy"))
    got = jpp.pipeline_speech_encode(speech, params["speech"], j["fbank"], j["frame_lens"],
                                     mesh=mesh(2, 4), num_microbatches=2)
    out["speech_emb"], out["speech_encoded"] = got.sentence_embeddings, got.encoded_seqs
    with pytest.raises(ValueError, match="not divisible"):
        jpp.pipeline_encoder_stack(layers[4], jnp.zeros((8, 4, D)), None, HEADS, ACT,
                                   mesh(8, 1))
    return _np_tree(out)


def _port_refs(params, data):
    """The single-device port, each stack run microbatch by microbatch
    (``data * m`` chunks of the global batch, in the ranks' order)."""
    t = {k: torch.from_numpy(v) for k, v in data.items() if k != "conformer_cfg"}
    layers = {n: _torch_tree(params[f"layers{n}"]) for n in (4, 8)}

    def stack(p, n, x, bias=None):
        return _chunked(lambda xx, bb: encoder_stack(p, xx, bb, HEADS, ACT), n, x, bias)

    out = {}
    for stage, d, m in PP_CASES:
        key = f"{stage}x{d}x{m}"
        out[f"stack_{key}"] = stack(layers[8 if stage == 8 else 4], d * m, t[f"x_{key}"],
                                    t[f"bias_{key}"])
    out["nobias"] = stack(layers[4], 8, t["x_nobias"])
    out["bf16"] = stack(_torch_tree(params["layers4"], torch.bfloat16), 8,
                        t["x_bf16"].to(torch.bfloat16))
    out["int8"] = stack(quantize_params_int8(layers[4]), 8, t["x_int8"])
    leaves = {k: torch.tensor(v, requires_grad=True)
              for k, v in flatten_params(params["layers4"]).items()}
    x = t["x_grads"].clone().requires_grad_(True)
    (encoder_stack(unflatten_params(leaves), x, None, HEADS, ACT) ** 2).sum().backward()
    text = text_encoder_from_numpy(params["text"], _text_cfg(4, sonar_text_encoder_archs))

    def text_encode(seqs, lens, d, m):
        return _chunked(lambda s, n: text.forward_with(
            text.params.tree(), s, n, stack_fn=lambda p, x, b: stack(p, m, x, b)
        ).sentence_embeddings, d, seqs, lens)

    out["text_encode"] = text_encode(t["seqs"], t["lens"], 2, 4)
    out["default_m"] = text_encode(t["seqs8"], t["lens8"], 4, 2)
    ccfg = ConformerConfig(**CONFORMER)
    conf = _torch_tree(params["conformer"])
    out["conformer"] = _chunked(lambda x, b, mk: conformer_stack(conf, x, b, mk, ccfg), 8,
                                t["cx"], t["cbias"], t["cmask"])
    speech = speech_encoder_from_numpy(params["speech"], sonar_speech_encoder_archs.get("toy"))
    scfg = speech.config.conformer

    def speech_rows(field):
        def run(f, n):
            return getattr(speech.forward_with(
                speech.params.tree(), f, n, stack_fn=lambda p, x, b, mk: _chunked(
                    lambda xx, bb, mm: conformer_stack(p, xx, bb, mm, scfg), 2, x, b, mk)),
                field)

        return _chunked(run, 4, t["fbank"], t["frame_lens"])

    out["speech_emb"] = speech_rows("sentence_embeddings")
    out["speech_encoded"] = speech_rows("encoded_seqs")
    refs = {k: v.detach().float().numpy() for k, v in out.items()}
    refs["grads"] = {**{k: v.grad.numpy() for k, v in leaves.items()}, "x": x.grad.numpy()}
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline_parallel")
    text = _np_tree(JaxText(_text_cfg(4, jtext)).init_params(jax.random.PRNGKey(0)))
    params = {
        "layers4": text["encoder"]["layers"],
        "layers8": _np_tree(JaxText(_text_cfg(8, jtext)).init_params(
            jax.random.PRNGKey(0))["encoder"]["layers"]),
        "text": text,
        "conformer": _np_tree(jconf.init_conformer_stack(jax.random.PRNGKey(0),
                                                         jconf.ConformerConfig(**CONFORMER))),
        "speech": _np_tree(JaxSpeech(jspeech.get("toy")).init_params(jax.random.PRNGKey(1))),
    }
    data = _inputs()
    save_params(tmp / "inputs.npz", {**params, "data": data})
    procs = start_world("pipeline", 8, tmp)
    try:
        jax_out = _jax_refs(params, data)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            port = _port_refs(params, data)
        finally:
            torch.set_num_threads(threads)
    finally:
        ranks = finish_world(procs, "pipeline", tmp, timeout=120.0)
    return {"ranks": ranks, "jax": jax_out, "port": port, "params": params}


def _check(world, key):
    for rank, out in enumerate(world["ranks"]):
        got = np.asarray(out[key], np.float32)
        np.testing.assert_array_equal(got, world["port"][key], err_msg=f"rank {rank}")
        np.testing.assert_allclose(got, world["jax"][key], atol=2e-4, err_msg=f"rank {rank}")


@pytest.mark.parametrize("stage,data,m", PP_CASES)
def test_pp_stack_matches_scan(world, stage, data, m):
    _check(world, f"stack_{stage}x{data}x{m}")


def test_pp_stack_no_bias(world):
    _check(world, "nobias")


def test_pp_full_text_encode_matches_single_device(world):
    """The encode of ``pipeline_shard_params``' tree; and the split rule
    itself: the stacked layer leaves split over ``stage``, the rest whole."""
    from sonar_tpu_torch.parallel import pipeline as pp
    from sonar_tpu_torch.parallel.comm import SINGLE
    from sonar_tpu_torch.parallel.mesh import Mesh

    _check(world, "text_encode")
    specs = pp.pipeline_param_shardings(world["params"]["text"],
                                        Mesh(2, 4, 0, SINGLE, SINGLE, SINGLE, axis="stage"))
    assert specs["encoder"]["layers"]["ffn"]["inner_proj"]["kernel"] == ("stage",)
    assert specs["layer_norm"]["weight"] == ()


def test_pp_conformer_stack_matches_scan(world):
    _check(world, "conformer")


def test_pp_full_speech_encode_matches_single_device(world):
    _check(world, "speech_emb")
    _check(world, "speech_encoded")


def _row_cos(a, b):
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_pp_bf16_stack(world):
    for rank, out in enumerate(world["ranks"]):
        got = np.asarray(out["bf16"], np.float32)
        np.testing.assert_array_equal(got, world["port"]["bf16"], err_msg=f"rank {rank}")
        assert _row_cos(got, world["jax"]["bf16"]).min() >= 0.9999, rank


def test_pp_int8_quantized_params(world):
    """int8 leaves (column-major ``kernel_q`` and ``scale``) are stacked on
    the same L axis: the stage's slice keeps the layout, and the whole tree
    and ``pipeline_shard_params``'s give the same bits."""
    for rank, out in enumerate(world["ranks"]):
        got = np.asarray(out["int8"], np.float32)
        np.testing.assert_array_equal(got, world["port"]["int8"], err_msg=f"rank {rank}")
        np.testing.assert_array_equal(np.asarray(out["int8_placed"]), got)
        # q, k, v, the output projection and the FFN's two: six int8 kernels.
        assert out["int8_column_major"].size == 6 and out["int8_column_major"].all()
        assert _row_cos(got, world["jax"]["int8"]).min() >= 0.999, rank


def _slice(leaf, rank, stage):
    """Rank ``rank``'s stage slice of a stacked leaf (rank = d * stage + s)."""
    n = leaf.shape[0] // stage
    return leaf[(rank % stage) * n:(rank % stage + 1) * n]


@pytest.mark.parametrize("remat", [False, True])
def test_pp_grads_match_scan(world, remat):
    key = f"grads_remat{int(remat)}"
    want = {**flatten_params(world["jax"][key]["params"]), "x": world["jax"][key]["x"]}
    for rank, out in enumerate(world["ranks"]):
        got = {**flatten_params(out[key]["params"]), "x": out[key]["x"]}
        assert got.keys() == want.keys()
        mine = {p: g if p == "x" else _slice(g, rank, 4) for p, g in got.items()}
        for path, w in want.items():
            w = w if path == "x" else _slice(w, rank, 4)
            np.testing.assert_allclose(mine[path], w, atol=1e-3 * max(1.0, np.abs(w).max() * 1e-2),
                                       err_msg=f"rank {rank} {path}")
        port = {p: w if p == "x" else _slice(w, rank, 4) for p, w in world["port"]["grads"].items()}
        assert grad_error(mine, port) <= 1e-4, rank


def test_pp_rejects_indivisible_layers(world):
    for out in world["ranks"]:
        assert "not divisible" in str(out["refusal"])


def test_pp_default_microbatches_uses_local_batch(world):
    """Global B 8 on data 4 x stage 2: the local batch is 2, so the default
    schedules m = 2 (a global default of min(stages, 8) would not divide)."""
    _check(world, "default_m")


def test_runtimes_refuse_a_stage_or_seq_mesh():
    """A runtime's or the train step's ``mesh=`` is a (data, model) mesh;
    the pipeline and sequence functions refuse one. Each refuses before any
    collective, so one process shows it."""
    from sonar_tpu_torch.inference_pipelines.text import TorchTextEncoder
    from sonar_tpu_torch.parallel import pipeline as pp, sequence as sp
    from sonar_tpu_torch.parallel.comm import SINGLE
    from sonar_tpu_torch.parallel.mesh import SINGLE_MESH, Mesh
    from sonar_tpu_torch.training.train_step import make_train_step

    text = text_encoder_from_numpy(_np_tree(JaxText(jtext.get("toy")).init_params(
        jax.random.PRNGKey(0))), sonar_text_encoder_archs.get("toy"))
    for axis in ("stage", "seq"):
        mesh = Mesh(1, 2, 0, SINGLE, SINGLE, SINGLE, axis=axis)
        with pytest.raises(ValueError, match=f"not a \\(data, {axis}\\) one"):
            TorchTextEncoder(text, device="cpu", mesh=mesh)
        with pytest.raises(ValueError, match=f"not a \\(data, {axis}\\) one"):
            make_train_step(lambda p, b, g: None, mesh)
    layers = text.params.tree()["encoder"]["layers"]
    x = torch.zeros(2, 4, 32)
    with pytest.raises(ValueError, match="takes a \\(data, stage\\) mesh"):
        pp.pipeline_encoder_stack(layers, x, None, 2, ACT, SINGLE_MESH)
    with pytest.raises(ValueError, match="takes a \\(data, seq\\) mesh"):
        sp.sequence_conformer_stack({}, x, None, None, ConformerConfig(), SINGLE_MESH)


def test_pp_rejects_a_local_batch_the_microbatches_do_not_divide():
    """JAX asserts it inside ``shard_map``; the port raises before any
    transfer, so one process shows it."""
    from sonar_tpu_torch.parallel import pipeline as pp
    from sonar_tpu_torch.parallel.comm import SINGLE
    from sonar_tpu_torch.parallel.mesh import Mesh

    layers = _torch_tree(_np_tree(JaxText(_text_cfg(4, jtext)).init_params(
        jax.random.PRNGKey(0)))["encoder"]["layers"])
    mesh = Mesh(1, 2, 0, SINGLE, SINGLE, SINGLE, axis="stage")
    with pytest.raises(ValueError, match="does not split into 2 microbatches"):
        pp.pipeline_encoder_stack(layers, torch.zeros(3, 4, D), None, HEADS, ACT, mesh,
                                  num_microbatches=2)
