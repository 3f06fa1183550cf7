#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``sonar_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing ``#`` lines:

(a) setup: a CUDA device must be present (otherwise exit 2, no result);
    prints the card's name and power limit as nvidia-smi gives them;
(b) build: compiles the CUDA kernels from ``sonar_tpu_torch/csrc`` (nvcc,
    sm_90a) and prints the build time and the compiler's register report;
(c) kernels: each of the four kernels against its plain PyTorch version on
    the card, at the main path's shapes, with the tolerance stated, and
    both timed with CUDA events (plain, kernel, kernel, plain);
(d) the slice: the ``basic`` SONAR text encoder at full width (24 layers,
    D 1024, 16 heads, FFN 8192, vocabulary 256,206) with seeded random
    weights, behind ``TextToEmbeddingModelPipeline.predict`` with a
    synthetic NLLB SentencePiece model. int8 and bf16 with static batching
    (lengths reach the 256 and 384 buckets), int8 with dynamic batching
    (batch_size=5) and fp32 with dynamic batching. The four launch counters
    are zeroed before and read after; each must be > 0. Embeddings of 16
    sentences are held against the same pipeline on the CPU (the plain
    path): cosine >= 0.999 for int8 and bf16, max-abs <= 1e-3 for fp32.

Prints the kernels' JSON record on the line before the last, and as the last
line ``{"ok": true, "device": {...}}``. Any failure raises (exit != 0).
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
import subprocess
import sys
import time

REPO = Path(__file__).resolve().parent
DEVICE = "cuda"
F32_MIN = -3.4028234663852886e38
N_SENTENCES = 3000  # corpus of the slice phase

KERNELS = {  # name -> (CUDA source, TPU kernel it replaces)
    "short_qkv_attention": ("sonar_tpu_torch/csrc/short_attn.cu",
                            "sonar_tpu/ops/pallas/short_attn.py:59"),
    "fused_attn_block": ("sonar_tpu_torch/csrc/attn_block.cu",
                         "sonar_tpu/ops/pallas/attn_block.py:106"),
    "fused_int8_ffn": ("sonar_tpu_torch/csrc/ffn.cu",
                       "sonar_tpu/ops/pallas/ffn.py:206"),
    "flash_attention": ("sonar_tpu_torch/csrc/flash.cu",
                        "sonar_tpu/ops/pallas/flash.py:52"),
}


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


# -- (a) setup -------------------------------------------------------------------


def setup():
    if not (REPO / "sonar_tpu_torch").is_dir() or not (REPO / "sonar_tpu").is_dir():
        log(f"{REPO} is not a checkout of the repository (no sonar_tpu_torch/)")
        sys.exit(2)
    try:
        import torch
    except ImportError:
        log("torch is not installed")
        sys.exit(2)
    if not torch.cuda.is_available():
        log("no CUDA device: this script drives the port on an NVIDIA GPU only")
        sys.exit(2)
    sys.path.insert(0, str(REPO))
    # The tracked native tokenizer library is not rebuilt here; its Python
    # fallback is bit-identical.
    os.environ["SONAR_TPU_NO_NATIVE"] = "1"
    card = f"{torch.cuda.get_device_name(0)}, power limit not readable"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        if smi.returncode == 0 and smi.stdout.strip():
            card = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError) as err:
        log(f"nvidia-smi failed: {err}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(card, flush=True)
    return torch, card


# -- (b) build -------------------------------------------------------------------


def build():
    from sonar_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    log(f"built {path.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s")
    for line in (_build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "Compiling entry function" in line or "Used" in line or "spill" in line:
            log("ptxas " + line.split(":", 1)[-1].strip()[:150])


# -- (c) kernels against their plain versions ---------------------------------------


def _timed(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _errors(torch, got, want):
    g, w = got.double().reshape(-1, got.shape[-1]), want.double().reshape(-1, want.shape[-1])
    max_abs = (g - w).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(g, w, dim=-1).min().item()
    finite = bool(torch.isfinite(g).all().item())
    return max_abs, cos, finite, w.abs().max().item()


def check_kernels(torch):
    from sonar_tpu_torch.ops.cuda import attn_block, ffn, flash, short_attn
    from sonar_tpu_torch.ops.quantization import quantize_kernel

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32

    def rand(*shape, scale=1.0, dtype=f32):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def key_bias(b, s):
        lens = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
        lens[::7] = 0  # padding rows of length 0 (all keys masked)
        lens[1] = s
        pos = torch.arange(s, device=dev)[None, :]
        return torch.where(pos < lens[:, None], 0.0, F32_MIN).float()

    results = {name: {"max_abs_err": 0.0} for name in KERNELS}
    failures = []

    def check(name, label, kernel_fn, plain_fn, rtol, min_cos, timed=False):
        """Pass if max|kernel - plain| <= rtol * max|plain| and every row's
        cosine >= min_cos, all values finite."""
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        max_abs, cos, finite, ref = _errors(torch, got, want)
        ok = finite and max_abs <= rtol * ref and cos >= min_cos
        log(f"check {name} {label}: max_abs {max_abs:.3e} (<= {rtol:.0e} x ref max {ref:.3g}) "
            f"min row cos {cos:.7f} (>= {min_cos}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} {label}")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], max_abs)
        if timed:
            iters = 20
            p1 = _timed(torch, plain_fn, iters)
            k1 = _timed(torch, kernel_fn, iters)
            k2 = _timed(torch, kernel_fn, iters)
            p2 = _timed(torch, plain_fn, iters)
            results[name].update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
            log(f"time {name} {label}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms")

    # Tolerances: fp32 attention agrees up to summation order (1e-5 of the
    # output scale); in bf16 an output may move by a few bf16 ulps where a
    # rounding of P or of the output flips (1e-2 of the scale, row cosine
    # >= 0.9999).
    # K1: short attention on the fused QKV layout.
    for b, s in ((64, 128), (1024, 8)):
        bias = key_bias(b, s)
        for dt, atol, mc in ((bf16, 1e-2, 0.9999), (f32, 1e-5, 0.999999)):
            qkv = rand(b, s, 3 * 1024, scale=0.5, dtype=dt)
            check("short_qkv_attention", f"[{b},{s},3072] {str(dt)[6:]}",
                  lambda: short_attn.short_qkv_attention(qkv, bias, 16),
                  lambda: short_attn.short_qkv_attention_plain(qkv, bias, 16),
                  atol, mc, timed=(b, s, dt) == (64, 128, bf16))

    # K4 and K3 quantise with the same rules as their plain versions; a
    # value within rounding of a quantisation step may land one int8 level
    # apart (LN statistics are summed in another order), hence a relative
    # bound instead of equality: 5e-3 of the output scale in fp32, 1e-2 in
    # bf16 (where an output rounding may flip too), row cosine >= 0.9999.
    int8_tol = {bf16: 1e-2, f32: 5e-3}
    d, f = 1024, 8192
    wqkv, sqkv = quantize_kernel(rand(d, 3 * d, scale=0.03))
    wo, so = quantize_kernel(rand(d, d, scale=0.03))
    bqkv, bo = rand(3 * d, scale=0.05), rand(d, scale=0.05)
    ln_w, ln_b = 1 + rand(d, scale=0.1), rand(d, scale=0.1)
    for b, s in ((64, 128), (1024, 8)):
        bias = key_bias(b, s)
        for dt in (bf16, f32):
            x = rand(b, s, d, dtype=dt)
            blk = (x, bias, ln_w, ln_b, wqkv, sqkv, bqkv, wo, so, bo, 16)
            check("fused_attn_block", f"[{b},{s},{d}] {str(dt)[6:]}",
                  lambda: attn_block.fused_attn_block(*blk),
                  lambda: attn_block.fused_attn_block_plain(*blk),
                  int8_tol[dt], 0.9999, timed=(b, s, dt) == (64, 128, bf16))

    def ffn_weights(split_scales: bool):
        w1, w2 = rand(d, f, scale=0.03), rand(f, d, scale=0.01)
        if split_scales:
            # The first half of h is 8x the second and W2 evens out their
            # shares of the output: a kernel with one second-quant scale per
            # row instead of per (row, half) loses 3 bits on half the sum.
            w1[:, : f // 2] *= 8.0
            w2[: f // 2] /= 8.0
        return (*quantize_kernel(w1), rand(f, scale=0.05), *quantize_kernel(w2),
                rand(d, scale=0.05))

    for split_scales in (False, True):
        w1, s1, b1, w2, s2, b2 = ffn_weights(split_scales)
        for dt in (bf16, f32):
            x = rand(8192, d, dtype=dt)
            for ln in ((True, False) if not split_scales else (False,)):
                lnp = (ln_w, ln_b) if ln else (None, None)
                label = f"M=8192 D={d} F={f} ln={ln} {str(dt)[6:]}"
                check("fused_int8_ffn", label + (" halves 8x apart" if split_scales else ""),
                      lambda: ffn._fused_ffn_impl(x, w1, s1, b1, w2, s2, b2, *lnp, 2),
                      lambda: ffn.fused_ffn_plain(x, w1, s1, b1, w2, s2, b2, *lnp, 2),
                      int8_tol[dt], 0.9999, timed=ln and dt == bf16)
        if split_scales:  # the case must tell the two kinds of scale apart
            one, two = (ffn.fused_ffn_plain(x, w1, s1, b1, w2, s2, b2, None, None, n)
                        for n in (1, 2))
            gap, _, _, ref = _errors(torch, one, two)
            log(f"fused_int8_ffn halves 8x apart: one scale per row instead of per (row, "
                f"half) moves the output by {gap:.3e} (ref max {ref:.3g})")
            if gap <= int8_tol[f32] * ref:
                failures.append("fused_int8_ffn split-scale case does not discriminate")

    # K2: flash attention. P is normalised before its rounding to the value
    # dtype in both versions (as in the TPU kernel), so the tolerances are
    # those of K1.
    for s in (512, 384):
        q, k, v = (rand(16, 16, s, 64, dtype=bf16) for _ in range(3))
        kb = key_bias(16, s)[:, None, None, :]
        check("flash_attention", f"[16,16,{s},64] bf16 key-bias",
              lambda: flash.flash_attention(q, k, v, kb),
              lambda: flash.flash_attention_plain(q, k, v, kb),
              1e-2, 0.9999, timed=s == 512)
    seg = torch.arange(512, device=dev) // 128
    full = torch.where(seg[:, None] == seg[None, :], 0.0, F32_MIN).float()
    full = full.expand(16, 1, 512, 512).contiguous()
    for dt, atol, mc in ((bf16, 1e-2, 0.9999), (f32, 1e-5, 0.999999)):
        q, k, v = (rand(16, 16, 512, 64, dtype=dt) for _ in range(3))
        check("flash_attention", f"[16,16,512,64] {str(dt)[6:]} full-bias",
              lambda: flash.flash_attention(q, k, v, full),
              lambda: flash.flash_attention_plain(q, k, v, full), atol, mc)
    q, k, v = (rand(4, 8, 300, 128, dtype=bf16) for _ in range(3))
    check("flash_attention", "[4,8,300,128] bf16 no-bias",
          lambda: flash.flash_attention(q, k, v),
          lambda: flash.flash_attention_plain(q, k, v), 1e-2, 0.9999)

    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: {failures}")
    return results


# -- (d) the slice ----------------------------------------------------------------------


def _tokenizer(tmp: Path, rng):
    """A synthetic NLLB-style SentencePiece model: 4 specials, 6000 word
    pieces, letters; language codes are added as control symbols."""
    import numpy as np

    from sonar_tpu.tokenizers.spm_proto import (
        PIECE_CONTROL, PIECE_UNKNOWN, ModelProto, NormalizerSpecProto,
        SentencePieceProto as P, TrainerSpecProto, serialize_model_proto,
    )
    from sonar_tpu_torch.tokenizers.nllb import NllbTokenizer

    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = set()
    while len(words) < 6000:
        words.add("".join(rng.choice(letters, size=int(rng.integers(3, 9)))))
    words = sorted(words)
    pieces = [P("<blank>", 0.0, PIECE_CONTROL), P("<unk>", 0.0, PIECE_UNKNOWN),
              P("<s>", 0.0, PIECE_CONTROL), P("</s>", 0.0, PIECE_CONTROL)]
    pieces += [P("▁" + w, -1.0) for w in words]
    pieces += [P(c, -5.0) for c in letters] + [P("▁", -4.0)]
    proto = ModelProto(pieces=pieces,
                       trainer=TrainerSpecProto(unk_id=1, bos_id=2, eos_id=3, pad_id=1),
                       normalizer=NormalizerSpecProto())
    path = tmp / "synthetic_nllb.model"
    path.write_bytes(serialize_model_proto(proto))
    return NllbTokenizer(path, langs=["eng_Latn", "fra_Latn"], default_lang="eng_Latn"), words


def _corpus(rng, words, n):
    """Sentence lengths as FLORES-like text (lognormal, median ~18 tokens)
    plus a tenth long enough for the 256 and 384 buckets."""
    import numpy as np

    n_long = n // 10
    lens = list(np.clip(np.rint(rng.lognormal(2.9, 0.55, n - n_long)), 2, 124).astype(int))
    lens += list(rng.integers(130, 380, n_long))
    rng.shuffle(lens)
    return [" ".join(rng.choice(words, size=int(k))) for k in lens]


def run_slice(torch, card):
    import numpy as np

    from sonar_tpu_torch.assets.convert import init_text_encoder_params, text_encoder_from_numpy
    from sonar_tpu_torch.inference_pipelines.text import (
        TextToEmbeddingModelPipeline,
        TorchTextEncoder,
    )
    from sonar_tpu_torch.models.sonar_text import sonar_text_encoder_archs
    from sonar_tpu_torch.ops.cuda import attn_block, ffn, flash, short_attn

    mods = {"short_qkv_attention": short_attn, "fused_attn_block": attn_block,
            "fused_int8_ffn": ffn, "flash_attention": flash}
    cfg = sonar_text_encoder_archs.get("basic")
    rng = np.random.default_rng(0)
    tmp = REPO / "build" / "chip_smoke"
    tmp.mkdir(parents=True, exist_ok=True)
    tokenizer, words = _tokenizer(tmp, rng)
    corpus = _corpus(rng, words, N_SENTENCES)
    # The reference subset: 14 short sentences and 2 of ~250 tokens (the
    # 256 bucket on the card; small enough for the CPU).
    ref_idx = [i for i, t in enumerate(corpus) if len(t.split()) < 60][:14]
    long_ids = [i for i, t in enumerate(corpus) if 230 <= len(t.split()) <= 252][:2]
    if len(long_ids) != 2:
        raise RuntimeError("the corpus has no two sentences of ~250 tokens")
    ref_idx += long_ids
    ref_texts = [corpus[i] for i in ref_idx]

    t0 = time.perf_counter()
    params = init_text_encoder_params(cfg, seed=0)
    log(f"basic encoder weights drawn in {time.perf_counter() - t0:.1f} s "
        f"({cfg.num_encoder_layers} layers, D {cfg.model_dim}, "
        f"{cfg.num_encoder_attn_heads} heads, FFN {cfg.ffn_inner_dim}, vocab {cfg.vocab_info.size})")

    def pipeline(dtype, quantize, device):
        model = text_encoder_from_numpy(params, cfg, dtype, device)
        return TextToEmbeddingModelPipeline(
            TorchTextEncoder(model, fuse_qkv=True, quantize=quantize), tokenizer)

    runs = {}  # mode -> card embeddings of ref_texts
    gpu = {}
    for mode, dtype, quantize in (("int8", torch.bfloat16, True), ("bf16", torch.bfloat16, False),
                                  ("fp32", torch.float32, False)):
        gpu[mode] = pipeline(dtype, quantize, DEVICE)
    for mode in ("int8", "bf16"):  # warm: kernels, allocator, tokenizer caches
        gpu[mode].predict(corpus[:256], source_lang="eng_Latn", batching="static")
    torch.cuda.synchronize()

    for mod in mods.values():
        mod.LAUNCHES = 0
    tput = {}
    for mode in ("int8", "bf16"):
        t0 = time.perf_counter()
        emb = gpu[mode].predict(corpus, source_lang="eng_Latn", batching="static")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        tput[mode] = len(corpus) / dt
        if emb.shape != (len(corpus), cfg.model_dim) or not np.isfinite(emb).all():
            raise AssertionError(f"{mode}: embeddings of shape {emb.shape}, finite "
                                 f"{bool(np.isfinite(emb).all())}")
        runs[mode] = emb[ref_idx]
        stats = gpu[mode].model.stats.snapshot()
        log(f"slice {mode} static: {len(corpus)} sentences in {dt:.2f} s = {tput[mode]:.1f} "
            f"sentences/s end to end (host tokenization included), padding waste "
            f"{stats['padding_waste']}, on {card}")
    dyn = gpu["int8"].predict(ref_texts, source_lang="eng_Latn", batch_size=5)
    runs["int8 dynamic"] = dyn
    runs["fp32"] = gpu["fp32"].predict(ref_texts, source_lang="eng_Latn", batch_size=5)
    torch.cuda.synchronize()
    launches = {name: mod.LAUNCHES for name, mod in mods.items()}
    log(f"launches during the slice: {launches}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"the main path never launched: {missing}")

    # Encode-only rate: pre-batched, pre-tokenized corpus, int8 static.
    from sonar_tpu.data.batcher import StaticShapeBatcher
    from sonar_tpu_torch.inference_pipelines.text import _static_len_buckets_for

    enc = gpu["int8"].model
    batcher = StaticShapeBatcher(pad_value=1, len_buckets=_static_len_buckets_for(
        enc.max_source_len), tokens_per_batch=8192)
    tok = tokenizer.create_encoder(lang="eng_Latn")
    batches = list(batcher.batches([list(tok(t)) for t in corpus]))
    enc.encode_batches(batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc.encode_batches(batches)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_tok = sum(int(b.seq_lens.sum()) for b in batches)
    log(f"slice int8 encode only: {len(corpus) / dt:.1f} sentences/s, {n_tok / dt:.0f} real "
        f"tokens/s ({len(batches)} batches of 8192 padded tokens), on {card}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # The same pipelines on the CPU (plain path), on the 16 reference sentences.
    torch.set_num_threads(max(1, os.cpu_count() or 1))
    for mode, dtype, quantize in (("int8", torch.bfloat16, True), ("bf16", torch.bfloat16, False),
                                  ("fp32", torch.float32, False)):
        t0 = time.perf_counter()
        cpu = pipeline(dtype, quantize, "cpu").predict(ref_texts, source_lang="eng_Latn",
                                                       batch_size=5)
        got = {"int8": [runs["int8"], runs["int8 dynamic"]], "bf16": [runs["bf16"]],
               "fp32": [runs["fp32"]]}[mode]
        for g in got:
            cos = ((g * cpu).sum(1) / (np.linalg.norm(g, axis=1) * np.linalg.norm(cpu, axis=1)))
            max_abs = float(np.abs(g - cpu).max())
            ok = cos.min() >= 0.999 if mode != "fp32" else max_abs <= 1e-3
            log(f"slice {mode} card vs CPU on {len(ref_texts)} sentences: min cos "
                f"{cos.min():.6f}, max_abs {max_abs:.3e} {'ok' if ok else 'FAIL'} "
                f"(CPU {time.perf_counter() - t0:.1f} s)")
            if not ok:
                raise AssertionError(f"{mode}: the card disagrees with the CPU reference")
    return launches, tput


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    torch, card = setup()
    build()
    results = check_kernels(torch)
    launches, _ = run_slice(torch, card)
    record = [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
        for name, (src, tpu) in KERNELS.items()
    ]
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
