"""The port's sequence-parallel Conformer (``sonar_tpu_torch.parallel.
sequence``) against the JAX package's, in one gloo world of 8 ranks.

The world (``tests/torch_port_mesh_worker.py``, suite ``sequence``) runs
every case at once on (seq, data) meshes of (4, 2), (2, 4), (8, 1) and
(1, 8); this process computes JAX's result at JAX's own mesh on the 8
virtual CPU devices and the single-device port's stack. Every rank's output
is held against both: JAX within 2e-4 (fp32, the toy parity bound), the
port's one-device stack within 1e-5 (the shards run their products at other
shapes). Gradients (``test_sp_grads_match_single_device``'s loss), on every
leaf (each rank holds them all) and on the input: JAX's within JAX's bound,
``atol = 1e-3 * max(1, 1e-2 * max|g|)``; the one-device port's within 1e-4
of each leaf's scale (its max-abs, floored at a thousandth of the largest
leaf's: ``test_torch_port_mesh_training.py``'s form). JAX's bound is wider
than the attention leaves' gradients here (~5e-4), so it cannot see a K or V
gradient that misses the other ranks' queries; the second bound can.
"""

from pathlib import Path
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent.parent))
from torch_port_mesh_worker import SP_CASES, finish_world, grad_error, start_world  # noqa: E402

from sonar_tpu.models.sonar_speech import SonarSpeechEncoder as JaxSpeech  # noqa: E402
from sonar_tpu.models.sonar_speech import sonar_speech_encoder_archs as jspeech  # noqa: E402
from sonar_tpu.nn import conformer as jconf  # noqa: E402
from sonar_tpu.parallel import sequence as jsp  # noqa: E402
from sonar_tpu_torch.assets.checkpoint import flatten_params, save_params  # noqa: E402
from sonar_tpu_torch.assets.convert import speech_encoder_from_numpy  # noqa: E402
from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs  # noqa: E402
from sonar_tpu_torch.nn.conformer import ConformerConfig, conformer_stack  # noqa: E402

CONFORMER = dict(model_dim=64, num_layers=2, num_heads=4, ffn_inner_dim=128,
                 depthwise_kernel_size=7)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32) if np.asarray(a).dtype.kind
                                  == "f" else np.array(a), tree)


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.tensor(np.array(v))
            for k, v in tree.items()}


def _case(data, name, b, s, seed=0):
    """``test_sequence_parallel.py``'s ``_inputs``: x, a mask of lengths in
    [S/2, S] and its key bias."""
    rng = np.random.default_rng(seed)
    data[f"x_{name}"] = rng.normal(size=(b, s, 64)).astype(np.float32)
    lens = rng.integers(s // 2, s + 1, size=(b,))
    data[f"mask_{name}"] = np.arange(s)[None, :] < lens[:, None]
    data[f"bias_{name}"] = np.where(data[f"mask_{name}"], 0.0,
                                    -np.inf).astype(np.float32)[:, None, None, :]


def _inputs():
    data = {"conformer_cfg": {k: np.array(v) for k, v in CONFORMER.items()}}
    for n, d, s in SP_CASES:
        _case(data, f"{n}x{d}x{s}", d * 2, s)
    _case(data, "halo", 2, 32, seed=1)
    data["x_nomask"] = np.random.default_rng(3).normal(size=(4, 24, 64)).astype(np.float32)
    for s in (30, 32, 16):
        _case(data, str(s), 2, s)
    data["bad_bias"] = np.zeros((2, 4, 1, 32), np.float32)
    _case(data, "grads", 2, 16, seed=6)
    _case(data, "seq1", 2, 20)
    rng = np.random.default_rng(5)
    data["fbank"] = rng.normal(size=(4, 64, 8)).astype(np.float32)  # the toy's 8 mel bins
    data["frame_lens"] = np.array([64, 50, 40, 33], np.int32)
    return data


def _jax_refs(params, data):
    j = {k: jnp.asarray(v) for k, v in data.items() if k != "conformer_cfg"}
    cfg = jconf.ConformerConfig(**CONFORMER)
    one = jconf.ConformerConfig(**{**CONFORMER, "num_layers": 1})
    mesh = lambda n, d: jsp.make_seq_mesh(seq=n, data=d)  # noqa: E731
    out = {}
    for n, d, s in SP_CASES:
        key = f"{n}x{d}x{s}"
        out[f"stack_{key}"] = jsp.sequence_conformer_stack(
            params["conformer2"], j[f"x_{key}"], j[f"bias_{key}"], j[f"mask_{key}"], cfg,
            mesh(n, d))
    out["halo"] = jsp.sequence_conformer_stack(params["conformer1"], j["x_halo"],
                                               j["bias_halo"], j["mask_halo"], one, mesh(8, 1))
    out["nomask"] = jsp.sequence_conformer_stack(params["conformer2"], j["x_nomask"], None, None,
                                                 cfg, mesh(4, 2))
    got = jsp.sequence_speech_encode(JaxSpeech(jspeech.get("toy")), params["speech"], j["fbank"],
                                     j["frame_lens"], mesh=mesh(4, 2))
    out["speech_emb"], out["speech_encoded"] = got.sentence_embeddings, got.encoded_seqs

    def loss(p, xx):
        return jnp.sum(jsp.sequence_conformer_stack(p, xx, j["bias_grads"], j["mask_grads"], cfg,
                                                    mesh(4, 2)) ** 2)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params["conformer2"], j["x_grads"])
    out["grads"] = {"params": gp, "x": gx}
    out["seq1"] = jsp.sequence_conformer_stack(params["conformer2"], j["x_seq1"],
                                               j["bias_seq1"], j["mask_seq1"], cfg, mesh(1, 8))
    with pytest.raises(TypeError, match="incompatible shapes"):  # the halo wider than a shard
        jsp.sequence_conformer_stack(params["conformer2"], j["x_16"], j["bias_16"], j["mask_16"],
                                     cfg, mesh(8, 1))
    return _np_tree(out)


def _port_refs(params, data):
    t = {k: torch.from_numpy(v) for k, v in data.items() if k != "conformer_cfg"}
    cfg = ConformerConfig(**CONFORMER)
    one = ConformerConfig(**{**CONFORMER, "num_layers": 1})
    stack2, stack1 = _torch_tree(params["conformer2"]), _torch_tree(params["conformer1"])
    out = {}
    for n, d, s in SP_CASES:
        key = f"{n}x{d}x{s}"
        out[f"stack_{key}"] = conformer_stack(stack2, t[f"x_{key}"], t[f"bias_{key}"],
                                              t[f"mask_{key}"], cfg)
    out["halo"] = conformer_stack(stack1, t["x_halo"], t["bias_halo"], t["mask_halo"], one)
    out["nomask"] = conformer_stack(stack2, t["x_nomask"], None, None, cfg)
    speech = speech_encoder_from_numpy(params["speech"], sonar_speech_encoder_archs.get("toy"))
    got = speech.forward_with(speech.params.tree(), t["fbank"], t["frame_lens"])
    out["speech_emb"], out["speech_encoded"] = got.sentence_embeddings, got.encoded_seqs
    out["seq1"] = conformer_stack(stack2, t["x_seq1"], t["bias_seq1"], t["mask_seq1"], cfg)
    leaves = {k: torch.tensor(v, requires_grad=True)
              for k, v in flatten_params(params["conformer2"]).items()}
    x = t["x_grads"].clone().requires_grad_(True)
    from sonar_tpu_torch.assets.checkpoint import unflatten_params

    (conformer_stack(unflatten_params(leaves), x, t["bias_grads"], t["mask_grads"], cfg)
     ** 2).sum().backward()
    refs = {k: v.detach().numpy() for k, v in out.items()}
    refs["grads"] = {"params": {k: v.grad.numpy() for k, v in leaves.items()},
                     "x": x.grad.numpy()}
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sequence_parallel")
    params = {
        "conformer2": _np_tree(jconf.init_conformer_stack(
            jax.random.PRNGKey(0), jconf.ConformerConfig(**CONFORMER))),
        "conformer1": _np_tree(jconf.init_conformer_stack(
            jax.random.PRNGKey(1), jconf.ConformerConfig(**{**CONFORMER, "num_layers": 1}))),
        "speech": _np_tree(JaxSpeech(jspeech.get("toy")).init_params(jax.random.PRNGKey(4))),
    }
    data = _inputs()
    save_params(tmp / "inputs.npz", {**params, "data": data})
    procs = start_world("sequence", 8, tmp)
    try:
        jax_out, port = _jax_refs(params, data), _port_refs(params, data)
    finally:
        ranks = finish_world(procs, "sequence", tmp, timeout=120.0)
    return {"ranks": ranks, "jax": jax_out, "port": port}


def _check(world, key):
    for rank, out in enumerate(world["ranks"]):
        got = np.asarray(out[key], np.float32)
        np.testing.assert_allclose(got, world["port"][key], atol=1e-5, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got, world["jax"][key], atol=2e-4, err_msg=f"rank {rank}")


@pytest.mark.parametrize("seq,data,s", SP_CASES)
def test_sp_stack_matches_single_device(world, seq, data, s):
    _check(world, f"stack_{seq}x{data}x{s}")


def test_sp_wide_kernel_halo_spans_shard(world):
    """Shards of 4 frames at kernel 7: the halo of 3 is most of a shard."""
    _check(world, "halo")


def test_sp_no_mask(world):
    _check(world, "nomask")


def test_sp_full_speech_encode_matches_single_device(world):
    _check(world, "speech_emb")
    _check(world, "speech_encoded")


@pytest.mark.parametrize("case,match", [
    ("indivisible", "not divisible"),
    ("bias", "key bias"),
    ("halo", "shorter than the depthwise convolution's halo"),
])
def test_sp_refusals(world, case, match):
    """JAX's two refusals, and a shard shorter than the halo (16 frames over
    8 ranks at kernel 7: 2 < 3), where JAX's ``ppermute`` of the last 3
    frames of a 2-frame shard fails on shapes."""
    for out in world["ranks"]:
        assert match in str(out[f"refuse_{case}"])


def test_sp_grads_match_single_device(world):
    want_jax = {**flatten_params(world["jax"]["grads"]["params"]), "x": world["jax"]["grads"]["x"]}
    want_port = {**flatten_params(world["port"]["grads"]["params"]),
                 "x": world["port"]["grads"]["x"]}
    for rank, out in enumerate(world["ranks"]):
        got = {**flatten_params(out["grads"]["params"]), "x": out["grads"]["x"]}
        assert got.keys() == want_jax.keys()
        for path, w in want_jax.items():
            np.testing.assert_allclose(got[path], w, atol=1e-3 * max(1.0, np.abs(w).max() * 1e-2),
                                       err_msg=f"rank {rank} {path}")
        assert grad_error(got, want_port) <= 1e-4, rank


def test_sp_seq1_falls_back(world):
    _check(world, "seq1")
