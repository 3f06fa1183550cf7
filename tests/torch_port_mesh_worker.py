"""Ranks of a small gloo world for the port's scale-out tests.

``run_world(suite, world, workdir)`` (or ``start_world`` and then
``finish_world``) starts ``world`` copies of this module
as subprocesses, each ``python torch_port_mesh_worker.py SUITE RANK WORLD
WORKDIR``. Each joins a gloo process group through a file in ``workdir``
(``init_method="file://..."``, so that concurrent test workers never fight
over a port), reads the inputs the test wrote with ``assets.checkpoint.save_params``, runs the
suite's cases and writes its outputs to ``workdir/out_<rank>.npz``. Every
child has a timeout of its own; a child that fails or times out fails the
test with its output.

This module imports torch, numpy and ``sonar_tpu_torch`` only, never
``jax``: the tests compute the JAX references in their own process.
"""

from __future__ import annotations

import os
from pathlib import Path
import subprocess
import sys
from typing import Any, Callable, Dict, List

import numpy as np
from sonar_tpu_torch.assets.checkpoint import flatten_params, load_params, save_params

REPO = Path(__file__).resolve().parent.parent
LAYOUTS = ((2, 2), (4, 1), (1, 4))  # the (data, model) meshes of a world of 4


# -- the launcher (run by the tests) ------------------------------------------


def start_world(suite: str, world: int, workdir: Path) -> List[subprocess.Popen]:
    """Start ``suite`` on ``world`` ranks; ``finish_world`` collects them
    (the test computes its references meanwhile)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    env.pop("XLA_FLAGS", None)
    return [subprocess.Popen([sys.executable, __file__, suite, str(r), str(world), str(workdir)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             env=env, cwd=str(workdir))
            for r in range(world)]


def finish_world(procs: List[subprocess.Popen], suite: str, workdir: Path,
                 timeout: float = 150.0) -> List[Dict]:
    """Wait for the ranks of ``start_world``; -> each rank's outputs (a tree)."""
    outs = []
    try:
        for rank, p in enumerate(procs):
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {rank} of {suite} timed out after {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"MESH_WORKER_OK {rank}" in out, (
            f"rank {rank} of {suite} failed (exit {p.returncode}):\n{out[-4000:]}")
    return [load_params(workdir / f"out_{r}.npz") for r in range(len(procs))]


def run_world(suite: str, world: int, workdir: Path, timeout: float = 150.0) -> List[Dict]:
    """Run ``suite`` on ``world`` ranks; -> each rank's outputs (a tree)."""
    return finish_world(start_world(suite, world, workdir), suite, workdir, timeout)


def grad_error(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> float:
    """The largest error of the gradient leaves ``got`` against ``want`` (by
    path), each over its leaf's scale: the leaf's max-abs, floored at a
    thousandth of the largest leaf's (``test_torch_port_mesh_training.py``'s
    form; <= 1e-4 passes there)."""
    floor = 1e-3 * max(np.abs(w).max() for w in want.values())
    return max(np.abs(got[p] - w).max() / max(np.abs(w).max(), floor) for p, w in want.items())


# -- the suites (run in the ranks) --------------------------------------------


def _np(t: Any) -> np.ndarray:
    import torch

    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _grads(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Each leaf's gradient (an empty array where it has none), as a tree."""
    return {k: _grads(v) if isinstance(v, dict) else
            (np.zeros(0) if v.grad is None else _np(v.grad)) for k, v in tree.items()}


def _meshes():
    from sonar_tpu_torch.parallel.mesh import make_mesh

    return {f"{d}x{m}": make_mesh(d, m) for d, m in LAYOUTS}


def suite_encode(inp: Dict[str, Any], workdir: Path) -> Dict[str, Any]:
    import dataclasses

    import torch
    from sonar_tpu_torch.assets.convert import speech_encoder_from_numpy, text_encoder_from_numpy
    from sonar_tpu_torch.data.collate import SequenceBatch
    from sonar_tpu_torch.inference_pipelines.speech import TorchSpeechEncoder
    from sonar_tpu_torch.inference_pipelines.text import (
        TextToEmbeddingModelPipeline,
        TorchTextEncoder,
    )
    from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs
    from sonar_tpu_torch.models.sonar_text import sonar_text_encoder_archs
    from sonar_tpu_torch.ops.fbank import FbankConfig
    from sonar_tpu_torch.ops.quantization import int8_linear, quantize_kernel
    from sonar_tpu_torch.parallel.comm import all_sum
    from sonar_tpu_torch.parallel.mesh import shard_params
    from sonar_tpu_torch.tokenizers.nllb import NllbTokenizer

    toy = sonar_text_encoder_archs.get("toy")
    cfg = dataclasses.replace(toy, model_dim=64, ffn_inner_dim=256, num_encoder_attn_heads=4)
    encoder = text_encoder_from_numpy(inp["encoder"], cfg)
    data = inp["data"]
    batch = SequenceBatch(seqs=data["seqs"], seq_lens=data["lens"], true_batch=len(data["lens"]))
    tok = NllbTokenizer(workdir / "tok.model", langs=["eng_Latn", "fra_Latn"],
                        default_lang="eng_Latn")
    vocab = dataclasses.replace(toy.vocab_info, size=int(data["tok_vocab"]))
    pipe_encoder = text_encoder_from_numpy(
        inp["pipe_encoder"], dataclasses.replace(cfg, vocab_info=vocab))
    sentences = [str(s) for s in data["sentences"]]
    speech = speech_encoder_from_numpy(inp["speech"], sonar_speech_encoder_archs.get("toy"))
    waves = [data[f"wave{i}"] for i in range(3)]
    out: Dict[str, Any] = {}
    for name, mesh in _meshes().items():
        for q in (False, True):
            enc = TorchTextEncoder(encoder, quantize=q, device="cpu", mesh=mesh)
            out[f"{name}/{'int8' if q else 'fp32'}"] = enc.encode_batch(batch)
        out[f"{name}/pipeline"] = TextToEmbeddingModelPipeline(
            TorchTextEncoder(pipe_encoder, device="cpu", mesh=mesh), tok).predict(
            sentences, source_lang="eng_Latn", batch_size=3)
        out[f"{name}/speech"] = TorchSpeechEncoder(
            speech, fbank_config=FbankConfig(num_mel_bins=8), device="cpu",
            mesh=mesh).encode_waveforms(waves)
        # A row-parallel int8 projection whose row maximum lies in one rank's
        # slice: the absmax agreed over the model group, and the variant that
        # scales each slice by its own absmax.
        x = torch.from_numpy(data["absmax_x"])
        params = dict(zip(("kernel_q", "scale"), quantize_kernel(torch.from_numpy(
            data["absmax_w"]))), bias=torch.from_numpy(data["absmax_b"]))
        local = shard_params({"output_proj": params}, mesh)["output_proj"]
        n = x.shape[-1] // mesh.model
        x_local = x[:, mesh.model_index * n:(mesh.model_index + 1) * n]
        out[f"{name}/absmax"] = int8_linear(local, x_local, group=mesh.model_group)
        partial = int8_linear({k: local[k] for k in ("kernel_q", "scale")}, x_local)
        out[f"{name}/absmax_local"] = all_sum(partial, mesh.model_group) + params["bias"]
        out[f"{name}/qkv_local"] = shard_params(
            {"self_attn": {"qkv_proj": {"kernel": torch.from_numpy(data["qkv"])}}},
            mesh)["self_attn"]["qkv_proj"]["kernel"]
    return out


def suite_decode(inp: Dict[str, Any], workdir: Path) -> Dict[str, Any]:
    import dataclasses

    from sonar_tpu_torch.assets.convert import text_decoder_from_numpy
    from sonar_tpu_torch.generation.beam_search import BeamSearchConfig
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.generation.sampling import TopPSampler
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs

    data = inp["data"]
    toy = sonar_text_decoder_archs.get("toy")
    cfg = dataclasses.replace(toy, vocab_info=dataclasses.replace(
        toy.vocab_info, size=int(data["vocab"])))
    decoder = text_decoder_from_numpy(inp["decoder"], cfg)
    prefix = [int(t) for t in data["prefix"]]
    noise = data["noise"]
    out: Dict[str, Any] = {}
    for name, mesh in _meshes().items():
        runtime = TorchTextDecoder(decoder, device="cpu", mesh=mesh)
        tokens, scores, lens = runtime.generate_beam(
            data["memory"], prefix, BeamSearchConfig(beam_size=2, max_gen_len=6))
        out.update({f"{name}/beam_tokens": tokens, f"{name}/beam_scores": scores,
                    f"{name}/beam_lens": lens})
        tokens, scores, lens = runtime.generate_sample(
            data["memory"], prefix, TopPSampler(p=0.9), max_gen_len=6,
            noise=lambda step, shape: noise[step][: shape[0]])
        out.update({f"{name}/sample_tokens": tokens, f"{name}/sample_scores": scores,
                    f"{name}/sample_lens": lens})
        out[f"{name}/score"] = runtime.score(data["seqs"], data["seq_lens"], data["memory"])
        out[f"{name}/embed_rows"] = np.asarray(
            runtime.model.params.tree()["decoder_frontend"]["embed"]["weight"].shape[0])
    return out


def suite_sample(inp: Dict[str, Any], workdir: Path) -> Dict[str, Any]:
    """Sampling from a seed, with no noise hook, over a (data 2, model 1)
    mesh: each rank draws the rows it holds of the padded batch."""
    import dataclasses

    from sonar_tpu_torch.assets.convert import text_decoder_from_numpy
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.generation.sampling import TopKSampler, TopPSampler
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs
    from sonar_tpu_torch.parallel.mesh import make_mesh

    data = inp["data"]
    toy = sonar_text_decoder_archs.get("toy")
    cfg = dataclasses.replace(toy, vocab_info=dataclasses.replace(
        toy.vocab_info, size=int(data["vocab"])))
    runtime = TorchTextDecoder(text_decoder_from_numpy(inp["decoder"], cfg), device="cpu",
                               mesh=make_mesh(2, 1))
    prefix = [int(t) for t in data["prefix"]]
    out: Dict[str, Any] = {}
    for seed in data["seeds"].tolist():
        for name, sampler, min_len in (("top_p", TopPSampler(p=0.9), 1),
                                       ("top_k", TopKSampler(k=10), 3)):
            tokens, scores, lens = runtime.generate_sample(
                data["memory"], prefix, sampler, max_gen_len=int(data["gen"]),
                min_gen_len=min_len, seed=int(seed))
            out[f"{name}_{seed}"] = {"tokens": tokens, "scores": scores, "lens": lens}
    return out


def _text_models(inp: Dict[str, Any]):
    from sonar_tpu_torch.assets.convert import text_decoder_from_numpy, text_encoder_from_numpy
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs, sonar_text_encoder_archs

    return (text_encoder_from_numpy(inp["encoder"], sonar_text_encoder_archs.get("toy")),
            text_decoder_from_numpy(inp["decoder"], sonar_text_decoder_archs.get("toy")))


def _fresh(tree: Dict[str, Any]) -> Dict[str, Any]:
    import torch

    return {k: _fresh(v) if isinstance(v, dict) else torch.tensor(np.array(v))
            for k, v in tree.items()}


def _batch(data: Dict[str, Any], keys) -> Dict[str, Any]:
    import torch

    return {k: torch.tensor(data[k]) for k in keys}


TEXT_KEYS = ("src_tokens", "src_lens", "tgt_in", "tgt_out", "tgt_lens")


def suite_train(inp: Dict[str, Any], workdir: Path) -> Dict[str, Any]:
    import torch
    from sonar_tpu_torch.assets.convert import mutox_from_numpy, speech_encoder_from_numpy
    from sonar_tpu_torch.models.mutox.model import MutoxConfig
    from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs
    from sonar_tpu_torch.nn.core import tree_leaves
    from sonar_tpu_torch.parallel.comm import all_sum_coalesced
    from sonar_tpu_torch.parallel.mesh import data_sharding
    from sonar_tpu_torch.training import train_step as ts

    encoder, decoder = _text_models(inp)
    data = inp["data"]
    batch = _batch(data, TEXT_KEYS)
    whole = {"encoder": inp["encoder"], "decoder": inp["decoder"]}
    whole_leaves = flatten_params(whole)

    def loss_fn(p, b, gen):
        return ts.translation_loss(encoder, decoder, p["encoder"], p["decoder"], b, gen)

    meshes = _meshes()
    out: Dict[str, Any] = {}
    sgd0 = (lambda leaves: torch.optim.SGD(leaves, lr=0.0))
    for name in ("2x2", "4x1"):
        mesh = meshes[name]
        state = ts.init_train_state(_fresh(whole), sgd0, mesh=mesh)
        state, loss = ts.make_train_step(loss_fn, mesh)(state, batch)
        out[f"{name}/loss"] = _np(loss)
        out[f"{name}/grads"] = _grads(state.params)
    # Trap 4's wrong variant: each data rank's local token mean, the
    # gradients averaged over the data group.
    mesh = meshes["4x1"]
    state = ts.init_train_state(_fresh(whole), sgd0, mesh=mesh)
    local = {k: v[data_sharding(mesh, v.shape[0])] for k, v in batch.items()}
    loss_fn(state.params, local, None).backward()
    leaves = [leaf.grad for leaf in tree_leaves(state.params)]
    all_sum_coalesced(leaves, mesh.data_group)
    for g in leaves:
        g /= mesh.data
    out["4x1/grads_local_means"] = _grads(state.params)
    # Three AdamW steps.
    mesh = meshes["2x2"]
    state = ts.init_train_state(_fresh(whole), lambda leaves: torch.optim.AdamW(
        leaves, lr=3e-3, betas=(0.8, 0.95), eps=1e-4, weight_decay=0.05), mesh=mesh)
    step = ts.make_train_step(loss_fn, mesh)
    for _ in range(3):
        state, _ = step(state, batch)
    out["2x2/adamw"] = state.params
    # Dropout on: one Adam step with a generator seeded alike on every rank;
    # the replicated leaves must stay identical on every rank.
    for name in ("2x2", "1x4"):
        mesh = meshes[name]
        state = ts.init_train_state(_fresh(whole), lambda leaves: torch.optim.Adam(
            leaves, lr=1e-2), mesh=mesh)
        state, loss = ts.make_train_step(loss_fn, mesh)(
            state, batch, torch.Generator().manual_seed(0))
        kept = {k: v for k, v in flatten_params(state.params).items()
                if v.shape == whole_leaves[k].shape}  # the leaves kept whole
        out[f"{name}/dropout_replicated"] = kept
        out[f"{name}/dropout_loss"] = _np(loss)
    # A frozen encoder under a MuTox head.
    head_cfg = MutoxConfig(input_size=32)
    head = mutox_from_numpy(inp["head"], head_cfg, device="cpu")
    cls_batch = _batch(data, ("tokens", "lens", "labels"))
    mesh = meshes["2x2"]
    state = ts.init_train_state(_fresh({"encoder": inp["encoder"], "head": inp["head"]}),
                                sgd0, mesh=mesh)
    state, loss = ts.make_train_step(
        lambda p, b, g: ts.classifier_loss(encoder, head, p, b, g), mesh)(state, cls_batch)
    out["frozen/loss"] = _np(loss)
    out["frozen/grads"] = _grads(state.params)
    # Distillation into the toy Conformer (its heads and FFNs split).
    speech = speech_encoder_from_numpy(inp["speech"], sonar_speech_encoder_archs.get("toy"))
    state = ts.init_train_state(_fresh(inp["speech"]), sgd0, mesh=mesh)
    state, loss = ts.make_train_step(
        lambda p, b, g: ts.distillation_loss(speech, p, b, g), mesh)(
        state, {**_batch(data, ("inputs", "teacher_emb")),
                "lens": _batch(data, ("frame_lens",))["frame_lens"]})
    out["distill/loss"] = _np(loss)
    out["distill/grads"] = _grads(state.params)
    return out


def suite_mining(inp: Dict[str, Any], workdir: Path) -> Dict[str, Any]:
    from sonar_tpu_torch.parallel import mining

    data = inp["data"]
    meshes = _meshes()
    out: Dict[str, Any] = {}
    for name, axis in (("4x1", "data"), ("1x4", "model"), ("2x2", "data")):
        mesh = meshes[name]
        for case in ("ragged", "ties"):
            s, i = mining.sharded_cosine_topk(data[f"{case}_q"], data[f"{case}_bank"], 5, mesh,
                                              axis, device="cpu")
            out[f"{name}/{case}_scores"], out[f"{name}/{case}_idx"] = _np(s), i.numpy()
        out[f"{name}/xsim"] = np.asarray(mining.sharded_xsim(
            data["xsim_x"], data["xsim_y"], mesh, axis=axis, device="cpu"))
        out[f"{name}/xsim_int8"] = np.asarray(mining.sharded_xsim(
            data["xsim_x"], data["xsim_y"], mesh, axis=axis, dot_dtype="int8", approx=True,
            device="cpu"))
        out[f"{name}/xsim_pp"] = np.asarray(mining.sharded_xsim_pp(
            data["pp_x"], data["pp_y"], data["pp_d"], mesh, axis=axis, device="cpu"))
        out[f"{name}/xsim_pp_int8"] = np.asarray(mining.sharded_xsim_pp(
            data["pp_x"], data["pp_y"], data["pp_d"], mesh, axis=axis, dot_dtype="int8",
            approx=True, device="cpu"))
        for strategy in ("forward", "intersection", "union"):
            src, tgt, sc = mining.mine_bitexts(data["mine_x"], data["mine_y"], k=3,
                                               strategy=strategy, mesh=mesh, axis=axis,
                                               device="cpu")
            out[f"{name}/mine_{strategy}"] = {"src": src, "tgt": tgt, "sc": sc}
    return out


def suite_multihost(inp: Dict[str, Any], workdir: Path) -> Dict[str, Any]:
    import torch
    from sonar_tpu_torch.assets.convert import text_encoder_from_numpy
    from sonar_tpu_torch.data.collate import SequenceBatch
    from sonar_tpu_torch.inference_pipelines.text import TorchTextEncoder
    from sonar_tpu_torch.models.sonar_text import sonar_text_encoder_archs
    from sonar_tpu_torch.parallel import mining
    from sonar_tpu_torch.parallel.mesh import make_mesh, replicate
    from sonar_tpu_torch.parallel.multihost import global_batch_from_local, shard_for_host

    rank = torch.distributed.get_rank()
    world = torch.distributed.get_world_size()
    mesh = make_mesh(data=world, model=1)
    items = list(range(10))
    local = np.full((2, 4), float(rank * 2), np.float32) + np.arange(2, dtype=np.float32)[:, None]
    data = inp["data"]
    seqs = global_batch_from_local(mesh, data["seqs"][2 * rank:2 * rank + 2])
    lens = global_batch_from_local(mesh, data["lens"][2 * rank:2 * rank + 2])
    encoder = text_encoder_from_numpy(inp["encoder"], sonar_text_encoder_archs.get("toy"))
    emb = TorchTextEncoder(encoder, device="cpu", mesh=mesh).encode_batch(
        SequenceBatch(seqs=seqs.numpy(), seq_lens=lens.numpy(), true_batch=len(lens)))
    s, i = mining.sharded_cosine_topk(data["x_bank"], data["y_bank"], 4, mesh, device="cpu")
    src, tgt, sc = mining.mine_bitexts(data["x_bank"], data["y_bank"], k=4, mesh=mesh,
                                       device="cpu")
    tree = {"a": {"b": torch.full((3,), rank + 1.0),
                  "half": torch.full((2, 2), rank + 1.0, dtype=torch.bfloat16)},
            "c": torch.arange(4) * (rank + 1)}
    replicate(tree, mesh)
    return {"shard": np.asarray(shard_for_host(items)), "replicated": tree,
            "global": global_batch_from_local(mesh, local).numpy(),
            "seqs": seqs.numpy(), "emb": emb, "topk_scores": _np(s), "topk_idx": i.numpy(),
            "mine": {"src": src, "tgt": tgt, "sc": sc}}


PP_CASES = ((4, 2, 4), (4, 2, 2), (2, 4, 3), (8, 1, 8))  # (stage, data, microbatches)
SP_CASES = ((4, 2, 24), (2, 4, 16), (8, 1, 32))  # (seq, data, S)


def _torch(tree: Dict[str, Any], dtype: Any = None) -> Dict[str, Any]:
    import torch

    def leaf(a: np.ndarray) -> Any:
        t = torch.tensor(np.array(a))
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    return {k: _torch(v, dtype) if isinstance(v, dict) else leaf(v) for k, v in tree.items()}


def _refusal(fn: Callable[[], Any]) -> np.ndarray:
    """The message of the ValueError ``fn`` raises ("" when it returns)."""
    try:
        fn()
    except ValueError as err:
        return np.array(str(err))
    return np.array("")


def _loss_grads(fn: Callable, tree: Dict[str, Any], x: Any) -> Dict[str, Any]:
    """The gradients of sum(fn(tree, x) ** 2) over every leaf of ``tree``
    and over ``x``."""
    import torch
    from sonar_tpu_torch.assets.checkpoint import unflatten_params

    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in flatten_params(tree).items()}
    x = x.clone().requires_grad_(True)
    (fn(unflatten_params(leaves), x) ** 2).sum().backward()
    return {"params": unflatten_params({k: _np(v.grad) for k, v in leaves.items()}),
            "x": _np(x.grad)}


def suite_pipeline(inp: Dict[str, Any], workdir: Path) -> Dict[str, Any]:
    import dataclasses

    import torch
    from sonar_tpu_torch.assets.convert import speech_encoder_from_numpy, text_encoder_from_numpy
    from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs
    from sonar_tpu_torch.models.sonar_text import sonar_text_encoder_archs
    from sonar_tpu_torch.nn.conformer import ConformerConfig
    from sonar_tpu_torch.ops.quantization import is_column_major, quantize_params_int8
    from sonar_tpu_torch.parallel import pipeline as pp

    data = inp["data"]
    meshes = {(s, d): pp.make_pipeline_mesh(s, d) for s, d in ((4, 2), (2, 4), (8, 1))}
    cfg = dataclasses.replace(sonar_text_encoder_archs.get("toy"), model_dim=64,
                              ffn_inner_dim=256, num_encoder_attn_heads=4, num_encoder_layers=4)
    heads, act = cfg.num_encoder_attn_heads, cfg.activation_fn
    t = {k: torch.from_numpy(v) for k, v in data.items() if k != "conformer_cfg"}
    out: Dict[str, Any] = {}
    for stage, d, m in PP_CASES:
        layers = _torch(inp[f"layers{8 if stage == 8 else 4}"])
        out[f"stack_{stage}x{d}x{m}"] = pp.pipeline_encoder_stack(
            layers, t[f"x_{stage}x{d}x{m}"], t[f"bias_{stage}x{d}x{m}"], heads, act,
            meshes[stage, d], num_microbatches=m)
    layers = _torch(inp["layers4"])
    out["nobias"] = pp.pipeline_encoder_stack(layers, t["x_nobias"], None, heads, act,
                                              meshes[4, 2], num_microbatches=4)
    bf16 = _torch(inp["layers4"], torch.bfloat16)
    out["bf16"] = pp.pipeline_encoder_stack(bf16, t["x_bf16"].to(torch.bfloat16), None, heads,
                                            act, meshes[4, 2], num_microbatches=4)
    int8 = quantize_params_int8(layers)
    out["int8"] = pp.pipeline_encoder_stack(int8, t["x_int8"], None, heads, act, meshes[4, 2],
                                            num_microbatches=4)
    placed = pp.pipeline_shard_params({"encoder": {"layers": int8}}, meshes[4, 2])
    out["int8_placed"] = pp.pipeline_encoder_stack(placed["encoder"]["layers"], t["x_int8"],
                                                   None, heads, act, meshes[4, 2],
                                                   num_microbatches=4)
    kernels = [v for k, v in _flat_torch(placed).items() if k.endswith("kernel_q")]
    out["int8_column_major"] = np.array([is_column_major(k) for k in kernels])
    for remat in (False, True):
        out[f"grads_remat{int(remat)}"] = _loss_grads(
            lambda p, x: pp.pipeline_encoder_stack(p, x, None, heads, act, meshes[4, 2],
                                                   num_microbatches=4, remat=remat),
            inp["layers4"], t["x_grads"])
    out["refusal"] = _refusal(lambda: pp.pipeline_encoder_stack(
        layers, torch.zeros(8, 4, 64), None, heads, act, meshes[8, 1]))

    text = text_encoder_from_numpy(inp["text"], cfg)
    placed = pp.pipeline_shard_params(text.params.tree(), meshes[4, 2])
    out["text_encode"] = pp.pipeline_text_encode(text, placed, t["seqs"], t["lens"],
                                                 mesh=meshes[4, 2], num_microbatches=4)
    placed = pp.pipeline_shard_params(text.params.tree(), meshes[2, 4])
    out["default_m"] = pp.pipeline_text_encode(text, placed, t["seqs8"], t["lens8"],
                                               mesh=meshes[2, 4])

    ccfg = ConformerConfig(**{k: int(v) for k, v in data["conformer_cfg"].items()})
    out["conformer"] = pp.pipeline_conformer_stack(
        _torch(inp["conformer"]), t["cx"], t["cbias"], t["cmask"], ccfg, meshes[4, 2],
        num_microbatches=4)
    speech = speech_encoder_from_numpy(inp["speech"], sonar_speech_encoder_archs.get("toy"))
    got = pp.pipeline_speech_encode(speech, pp.pipeline_shard_params(
        speech.params.tree(), meshes[2, 4]), t["fbank"], t["frame_lens"], mesh=meshes[2, 4],
        num_microbatches=2)
    out["speech_emb"], out["speech_encoded"] = got.sentence_embeddings, got.encoded_seqs
    return out


def _flat_torch(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat_torch(v, key) if isinstance(v, dict) else {key: v})
    return out


def suite_sequence(inp: Dict[str, Any], workdir: Path) -> Dict[str, Any]:
    import torch
    from sonar_tpu_torch.assets.convert import speech_encoder_from_numpy
    from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs
    from sonar_tpu_torch.nn.conformer import ConformerConfig
    from sonar_tpu_torch.parallel import sequence as sp

    data = inp["data"]
    meshes = {(n, d): sp.make_seq_mesh(n, d) for n, d in ((4, 2), (2, 4), (8, 1), (1, 8))}
    cfg = ConformerConfig(**{k: int(v) for k, v in data["conformer_cfg"].items()})
    one = ConformerConfig(**{**{k: int(v) for k, v in data["conformer_cfg"].items()},
                             "num_layers": 1})
    t = {k: torch.from_numpy(v) for k, v in data.items() if k != "conformer_cfg"}
    stack2, stack1 = _torch(inp["conformer2"]), _torch(inp["conformer1"])
    out: Dict[str, Any] = {}
    for n, d, s in SP_CASES:
        key = f"{n}x{d}x{s}"
        out[f"stack_{key}"] = sp.sequence_conformer_stack(
            stack2, t[f"x_{key}"], t[f"bias_{key}"], t[f"mask_{key}"], cfg, meshes[n, d])
    out["halo"] = sp.sequence_conformer_stack(stack1, t["x_halo"], t["bias_halo"],
                                              t["mask_halo"], one, meshes[8, 1])
    out["nomask"] = sp.sequence_conformer_stack(stack2, t["x_nomask"], None, None, cfg,
                                                meshes[4, 2])
    speech = speech_encoder_from_numpy(inp["speech"], sonar_speech_encoder_archs.get("toy"))
    got = sp.sequence_speech_encode(speech, speech.params.tree(), t["fbank"], t["frame_lens"],
                                    mesh=meshes[4, 2])
    out["speech_emb"], out["speech_encoded"] = got.sentence_embeddings, got.encoded_seqs
    out["refuse_indivisible"] = _refusal(lambda: sp.sequence_conformer_stack(
        stack2, t["x_30"], t["bias_30"], t["mask_30"], cfg, meshes[4, 2]))
    out["refuse_bias"] = _refusal(lambda: sp.sequence_conformer_stack(
        stack2, t["x_32"], t["bad_bias"], t["mask_32"], cfg, meshes[4, 2]))
    out["refuse_halo"] = _refusal(lambda: sp.sequence_conformer_stack(
        stack2, t["x_16"], t["bias_16"], t["mask_16"], cfg, meshes[8, 1]))
    out["grads"] = _loss_grads(
        lambda p, x: sp.sequence_conformer_stack(p, x, t["bias_grads"], t["mask_grads"], cfg,
                                                 meshes[4, 2]),
        inp["conformer2"], t["x_grads"])
    out["seq1"] = sp.sequence_conformer_stack(stack2, t["x_seq1"], t["bias_seq1"],
                                              t["mask_seq1"], cfg, meshes[1, 8])
    return out


SUITES: Dict[str, Callable] = {
    "encode": suite_encode, "decode": suite_decode, "train": suite_train,
    "mining": suite_mining, "multihost": suite_multihost, "pipeline": suite_pipeline,
    "sequence": suite_sequence, "sample": suite_sample,
}


def main() -> None:
    suite, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    workdir = Path(workdir)
    import torch

    torch.set_num_threads(1)
    rendezvous = f"file://{workdir / 'rendezvous'}"
    if suite == "multihost":
        from sonar_tpu_torch.parallel.multihost import initialize

        initialize(rendezvous, rank=rank, world_size=world, backend="gloo")
    else:
        torch.distributed.init_process_group("gloo", init_method=rendezvous, rank=rank,
                                             world_size=world)
    out = SUITES[suite](load_params(workdir / "inputs.npz"), workdir)
    save_params(workdir / f"out_{rank}.npz", out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"MESH_WORKER_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
