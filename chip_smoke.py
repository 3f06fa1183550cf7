#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``sonar_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py --compare DIR [DIR ...]

The second form runs none of the phases below: it times the three
beam-attend kernels (``beam_diag_attend`` at batches of 32, 8 and 1, at
S 259 and in fp32), rel-pos v1 and v2, ``fused_bf16_ffn_ln_residual`` and
beam decoding with the full-width ``basic`` decoder (``times_of``) for each
checkout DIR (e.g. an unpacked parent commit under the git-ignored
``build/``) and this one in turns, each in a process of its own, each
building its kernels into its own ``build/``.

Phases, each printing ``#`` lines:

(a) setup: a CUDA device must be present (otherwise exit 2, no result);
    prints the card's name and power limit as nvidia-smi gives them;
(b) build: compiles the CUDA kernels from ``sonar_tpu_torch/csrc`` (nvcc,
    sm_90a) and prints the build time and the compiler's register report;
(c) kernels: the bf16 attention core's softmax division against
    ``__fdiv_rn``, bit for bit, on 2^36 operand pairs (``csrc/div_check.cu``);
    each of the twelve kernels against its plain PyTorch version on
    the card, at the main paths' shapes, with the tolerance stated, and
    both timed with CUDA events (plain, kernel, kernel, plain; the kernels
    line gives each kernel's first timed shape, v2 is timed in fp32 too),
    beside one PyTorch call of the same function where there is one
    (``scaled_dot_product_attention``) and the card's bound for the same
    work (bytes over 3.35 TB/s or operations over the operand type's peak,
    computed from the inputs), with the achieved op/s and the share of the
    bound; flash attention timed at S 512, 384 and 256, the short attention
    at [64, 128], [1024, 8] and [256, 32]; the three beam-attend kernels at the JAX
    kernel tests' shapes and the decode shape of (f), in bf16 and fp32
    (``beam_masked_attend`` timed in both); ``beam_masked_attend`` at the
    cache of max_gen_len 256 (S 259, idx 200) with a random and a tree
    ancestry (as beam search builds it), timed beside its distinct-row
    bound (warm, and with a cold L2), then on caches holding NaN at every position past idx and in
    every (row, position) pair no beam names (against the plain version on
    the clean caches) and called 16 times on one input, every output equal
    to the first bit for bit; the Conformer half-FFN
    (``fused_bf16_ffn_ln_residual``) at the ``english`` encoder's S 499
    batch and at the JAX test's shape, bf16 and fp32, beside the port's
    eager Conformer branch at the same shape, and at S 499 in bf16 beside
    ``torch.matmul`` on its two GEMMs' operands (a yardstick) with the
    device ms of each of its three launches; the
    int8 FFN beside ``torch._int_mm`` on its two GEMMs' pre-quantised
    operands (a yardstick, on a line of its own); rel-pos v2 timed at
    [8, 16, 499, 64] (bf16, fp32), [8, 16, 1999, 64] and [2, 16, 2499, 64]
    (past the gate, as a measurement), each bf16 time beside the bound's
    operation count, the trig form's and the L2 bytes of the kernel's
    tiling (inputs and output; the scores written and read back); rel-pos
    v2 in bf16 called 16 times on one input at [1, 16, 2048, 64],
    [2, 16, 1999, 64] and [8, 16, 499, 64], its workspace filled with NaN
    before each call, every output equal to the first bit for bit, and its
    fp32 time at [8, 16, 499, 64] held to 2.9114 ms plus 10%;
    rel-pos v1 at [8, 16, 499, 64] in bf16 (timed beside SDPA on q + u with
    the mask bd * Dh^-0.5 + key bias) and fp32 (timed), at [2, 2, 130, 64]
    fp32, [2, 16, 1999, 64] and [1, 8, 2048, 128] bf16, each called twice,
    equal bit for bit; ``beam_diag_attend`` (library call: SDPA on 4-D
    tensors, each query [1, 1, Dh] against the valid prefix of its own row
    [1, idx + 1, Dh], no mask) also at S 259, idx 200 (bf16 and fp32), idx 0,
    K 1 and 16, Dh 32 and 128, each on caches holding NaN at every position
    past idx (the same bits) and called 16 times, equal bit for bit, and
    timed in bf16 at S 259, warm and with a cold L2, beside its bound;
    ``beam_reorder_attend`` also with sel naming one row
    for every beam and the identity, K 1 and 16, Dh 32 and 128, idx 0 and
    S - 1, S 259, the new caches equal to the plain version's and two calls
    equal bit for bit each time, and timed in bf16 at the decode shape
    (random and one-row sel) and at S 259, idx 200, warm and with a cold L2;
    ``gumbel_max`` (the sampling step's draw, which replaces no Pallas
    kernel) at [32, 256206] and [128, 256206] over 48 steps, its noise and
    tokens equal to the plain version's bit for bit, timed at [32, 256206]
    beside its bound (integer operations over the INT32 lanes' rate);
    ``add_layer_norm`` (the Conformer block's residual add + LayerNorm,
    which replaces no Pallas kernel) at the speech cell's rows of 1,024 in
    bf16 (M 3,184, 15,984, 31,984; with x_out, without, without a branch)
    and fp32 (M 3,184), x_out equal to the eager sum bit for bit, each bf16
    shape timed warm and with a cold L2 beside its bytes bound, the plain
    version and ``layer_norm`` after an add (a yardstick);
(d) the slice: the ``basic`` SONAR text encoder at full width (24 layers,
    D 1024, 16 heads, FFN 8192, vocabulary 256,206) with seeded random
    weights, behind ``TextToEmbeddingModelPipeline.predict`` with a
    synthetic NLLB SentencePiece model. int8 and bf16 with static batching
    (lengths reach the 256 and 384 buckets), int8 with dynamic batching
    (batch_size=5) and fp32 with dynamic batching. The launch counters are
    zeroed before and read after; the four text kernels' must be > 0.
    Embeddings of 16 sentences are held against the same pipeline on the
    CPU (the plain path): cosine >= 0.999 for int8 and bf16, max-abs <=
    1e-3 for fp32. Then, outside the counted run, encode only (the
    pre-batched corpus) in int8 and bf16, and the device ms of one batch of
    8192 padded tokens at S 128 and at S 512 in each.
(e) the speech slice: the ``english`` SONAR speech encoder at full width
    (24 Conformer layers, D 1024, 16 heads x 64, FFN 4096, depthwise kernel
    31, 80 mel bins, 3-layer post-LN pooler) with seeded random weights,
    behind ``SpeechToEmbeddingModelPipeline.predict(batch_size=8)`` on 48
    synthetic 16 kHz clips (tones plus noise) whose length-sorted batches
    take every path: 8 of 1-2.5 s (plain rel-pos attention, S < 128), 24 of
    3-20 s and 8 of 25-40 s (the v2 kernel, S up to 1999), 8 of 45-50 s
    (plain, S 2499). bf16 and fp32; clips/s and RTFx; the launch counters
    and the plain-path calls are zeroed before and read after each run:
    v2 and the plain path must be > 0, ``add_layer_norm`` 5 a layer in
    every batch. Four clips (1.5, 2, 2.5 s in one
    batch with a padding row; 10 s alone) are held against the same
    pipeline on the CPU: cosine >= 0.999 in bf16, max-abs <= 1e-3 of the
    embeddings' scale in fp32.

(f) decoding: the ``basic`` SONAR text decoder at full width and depth (24
    layers, D 1024, 16 heads x 64, FFN 8192, vocabulary 256,206, tied output
    projection) with seeded random weights, in bf16 and fp32, behind
    ``EmbeddingToTextModelPipeline.predict`` on 64 embeddings of (d)'s bf16
    encoder (batch 32, beam 5, max_gen_len 48), and in bf16 behind
    ``TextToTextModelPipeline.predict`` on 16 sentences of (d)'s corpus with
    (d)'s bf16 encoder (batch 8). Sentences/s, generated tokens/s, ms per
    decode step, peak device memory; ``beam_masked_attend`` must launch
    exactly 24 times per step the card ran (prefix steps included), the
    diagonal and reorder kernels never. The device busy share over one bf16 batch
    comes from torch.profiler. Four embeddings are decoded on the CPU port
    too: the fp32 best hypotheses must agree (a tie within 1e-5 in score is
    printed, not failed) and the teacher-forced logits agree to 1e-3 of
    their scale in fp32, row cosine >= 0.999 in bf16.

(f2) the captured beam program: beam decode runs as CUDA graphs (the
    search's setup, then one step looped on the card by a conditional WHILE
    node until the device's exit flag says done: ``ops.cuda.graph_loop``);
    it is held against the same search run eagerly on the card
    (``_beam_eager``) on the 64 embeddings in bf16, fp32 and int8
    (``quantize=True``): tokens and lengths identical, scores bit for bit
    (or within 1e-5, the gap printed). Each path's sentences/s, ms per
    decode step and the steps the card ran (the eager body's gated steps
    included); the first call of a new key (max_gen_len 45: its capture)
    against the next, with the memory the graph holds; both bf16 busy
    shares over a batch of 32 (torch.profiler), whose trace of the graph
    path must show 24 ``beam_masked_attend`` launches a step the card ran;
    text -> text on 256 sentences of (d)'s corpus (batch 32): sequential
    ``batch_translate``, ``translate_stream`` with windows 1 and 2 and
    ``TextToTextModelPipeline.predict`` equal, each timed twice in turns.
    Every beam path of (f)-(l) launches ``beam_masked_attend`` 24 times per
    step the card ran (a replay's counted by ``ops.cuda.add_launches``).
(g) speech -> text: the ``english`` encoder and the ``basic`` decoder in
    bf16 behind ``SpeechToTextModelPipeline.predict(batch_size=8)`` on 16
    synthetic clips (8 of 3-20 s, 8 of 25-40 s: S 299-1999, the v2
    kernel), beam 5, max_gen_len 48, two batches in flight. Clips/s,
    sentences/s, ms per decode step; v2 must launch and
    ``beam_masked_attend`` exactly 24 times per step the card ran. The
    window against batch by batch on the clips twice over (32), equal, each
    timed twice in turns. Two short clips in fp32: the card's and the CPU's
    embeddings within 1e-3 of their scale, and the same best hypotheses.
(h) sampling, int8 decode and the heads: top-p 0.9 and top-k 10 sampling
    with the ``basic`` decoder in bf16 and fp32 on (d)'s 64 embeddings
    (batch 32, max_gen_len 48; the captured program, ``gumbel_max``
    launched), and in fp32 on 4 embeddings against the CPU port with the
    same Gumbel noise drawn on the host (``noise`` hook, the eager body;
    identical tokens, a tie within 1e-5 printed); int8 decode (``quantize=True``, beam 5) on
    the 64 embeddings and on 2 (10 beam rows, ``int8_matmul``'s float64
    route), its teacher-forced logits' row cosine >= 0.99 against the
    card's fp32 decoder and >= 0.9999 against the CPU port in int8; BLASER
    ``basic_ref`` and ``basic_qe`` and MuTox on 3000 embeddings of (d),
    the MuTox speech pipeline on 8 clips, and LASER2 (``laser2``: 5 x
    BiLSTM 512) on 512 sentences of (d)'s corpus, each at its published
    width with seeded random weights, against the CPU port in fp32 to 1e-4
    of the output's scale.

(h2) the captured sampling program: sampling runs as CUDA graphs (the
    setup, then one step looped on the card until the device's exit flag
    says done), its draw JAX's threefry noise from the seed's key words and
    the device step counter (``gumbel_max``); it is held against the same
    loop run eagerly on the card (``_sample_eager``) on the 64 embeddings,
    top-p 0.9 and top-k 10, max_gen_len 48, in bf16, fp32 and int8: tokens,
    scores and lengths bit for bit, ``gumbel_max`` launched once a body step
    the card ran, each path's ms a decode step. In bf16: the same seeds
    repeat their samples and other seeds give others; a new key's capture
    (max_gen_len 45, a runtime of its own) timed with the memory it holds;
    both busy shares over a top-p batch of 32 (the eager body's over 16
    steps); the fresh-noise check (a flat filter for 48 steps:
    each row's tokens >= 40 distinct values; a draw fixed at capture would
    give 1). fp32 top-p from one seed on 4 embeddings against the CPU port
    (its plain draw): identical tokens, a tie within 1e-5 printed.

(i) mining: ``sonar_tpu_torch.parallel.mining.cosine_topk`` at
    ``scripts/bench_mining.py``'s size (65,536 x 65,536 unit rows, D 1024,
    top 8; y a normalised noisy copy of x, cosine ~0.45 to its planted
    partner) in fp32, bf16 and int8, exact and approx (one selector: the
    two must agree bit for bit), with ms and query rows/s and each mode's
    device busy time and top six device operations (torch.profiler); the planted
    partner's rank and each mode's recall@8 against the card's fp32;
    512 query rows against the CPU run of the same rows on the whole bank
    (fp32 scores within 1e-5 and indices equal but in rows with a tie
    within 1e-6; int8 equal bit for bit; bf16 scores within 1e-2, recall
    >= 0.99); ``mine_bitexts`` (intersection, ratio) pair count and
    planted-pair precision (>= 0.9 n pairs, precision >= 0.99); ``xsim`` and
    ``xsim_pp`` at FLORES devtest size (1,012 rows, 10,000 distractors),
    every margin, error rates equal to the CPU's. Mining launches no kernel
    of the port: its products and selection are PyTorch calls.

(j) serving, packing and the HF layer, on the models of (d), (e) and (f):
    (j1) the port's ``EmbeddingServer`` (``warmup=True``, max_wait_ms 10)
    with (d)'s int8 text pipeline on /embed, a ``TextToTextModelPipeline``
    of (d)'s bf16 encoder and (f)'s bf16 decoder on /translate and (e)'s
    bf16 speech pipeline on /embed_speech, fired at by the port's
    ``SonarClient``: one /embed request alone (equal bit for bit to the
    pipeline's direct static ``predict``), then 8 threads x 16 /embed
    requests of 1-32 sentences of (d)'s corpus beside 2 threads x 4
    /embed_speech requests of 2 clips of 3-20 s (cosine >= 0.999 per
    sentence or clip against direct ``predict``), then one /translate
    request of 4 sentences alone (equal to direct ``predict``); /metrics
    must count every request and item with no error, the launch counts of
    #1 or #2, #3, #5, #6 and #8 must be > 0 (threads share the counters),
    /healthz must read ``draining`` after ``drain()``, and the server is
    stopped in a ``finally``. Prints each endpoint's requests/s, items/s,
    p50 / p95 latency and mean batch occupancy, and the encoder's padding
    waste. (j2) TF32 switched on as a user may have it, (d)'s fp32 text
    pipeline and (e)'s fp32 speech pipeline served at once (4 threads of 2
    requests each): the three precision flags must read afterwards what
    they read before the server started, and the replies agree with direct
    fp32 ``predict`` within 1e-3 of the scale. (j3) (d)'s corpus packed
    (``pack_sequences``, rows of 128, 64 rows a batch, up to 16 segments a
    row) through ``apply_packed`` in int8 and bf16: flash attention in
    full-bias mode (and in int8 ``fused_int8_ffn``) must launch, every
    output be finite, each sentence of <= 128 tokens within cosine 0.999 of
    its static-batch embedding of (d); 16 packed rows against the CPU port
    within the same limit; encode-only sentences/s, padding waste and MFU
    (``sonar_tpu_torch.utils.flops``) of packed against static batching on
    the same sentences. (j4) the HF layer's ``process_batch`` on plain
    dicts: text -> embedding (a flat and a list-of-sentences column, 256
    rows each) and audio -> embedding (8 clips) equal bit for bit to direct
    ``predict`` on the same batches, embedding -> text (8 embeddings) equal
    to it; rows/s.

(k) training, with ``sonar_tpu_torch.training`` (fp32 leaves, bf16 compute
    in (k1)-(k3)): (k1) ``translation_loss`` on the full-width ``basic``
    encoder and decoder (weights of (d) and (f), q/k/v fused), AdamW,
    dropout from a seeded generator on the card, a fixed batch of 16
    sentences of (d)'s corpus cut to 64 tokens, each its own target; (k2)
    ``distillation_loss`` (mse) of the full-width ``english`` Conformer
    (weights of (e)) towards 4 of (d)'s bf16 embeddings, on 4 clips of
    5-10 s; each 2 warm-up and 5 timed steps: ms a step, tokens/s, MFU (3 x
    the forward's matmul FLOPs), peak device memory, one more step's busy
    share and top device operations under torch.profiler; the loss must
    fall over the timed steps and every launch count read 0 (autograd
    records, so every gate takes the plain path). (k1)'s state is freed
    before (k2). (k3) MuTox's head trained 3 steps on (d)'s frozen bf16
    encoder: ``short_qkv_attention`` must launch (the frozen forward is
    inference), the encoder stay bit for bit, the head change. (k4) one
    fp32 step of the ``basic`` encoder and decoder cut to 2 layers on the
    card and on the CPU port (4 x 64, dropout off): the loss within 1e-5 of
    the CPU's, every gradient leaf within 1e-4 of its scale (the
    cross-attention's q and k projections, zero in exact arithmetic, read
    zero at that resolution), no launch, and a TF32 control (the fp32 scope
    switched off) above that limit.

(l) scale-out over ``torch.distributed``, in three child processes started
    together (``--scaleout-child``; the main process never joins a group),
    each check timed: (l1) one rank over NCCL, ``make_mesh(1, 1)``: the
    ``basic`` encoder in int8 and bf16 through ``TextToEmbeddingModelPipeline``
    over ``TorchTextEncoder(mesh=)`` on (d)'s 3000 sentences, equal to (d)'s
    embeddings bit for bit with (d)'s launch counts of #1, #2, #3 and #5;
    ``TorchTextDecoder(mesh=)`` on (f)'s 64 embeddings, every beam output
    equal to (f)'s; ``sharded_cosine_topk`` at (i)'s size, equal to (i)'s
    fp32 top 8; a ``make_train_step(mesh=)`` step of (k4)'s model, its loss
    equal to (k4)'s and every gradient leaf to the mesh-free step's but the
    two embedding tables (sums by atomic adds, which differ between any two
    runs: within (k4)'s limit). (l2) two ranks sharing the card over gloo:
    every collective the port issues on CUDA tensors; ``make_mesh(1, 2)``:
    the bf16 and int8 encoders on 64 sentences (16 of >= 250 words), cosine
    >= 0.999 per sentence against (d), #1 and #5 launched on each rank, #2
    and #3 not; int8 also bit for bit against the layers' model-split path
    on one rank, and two planted wrong int8 variants (the row absmax not
    agreed; each slice scaled alone) that this check must catch;
    ``make_mesh(2, 1)``: the int8 encoder on the 3000
    sentences, equal to (d) bit for bit; one DP = 2 step of (k4)'s model
    against the single-rank step within (k4)'s limits.

(m) pipeline and sequence parallelism, in one pair of child processes
    (``--scaleout-child m``, started with (l)'s three: the five run at
    once) sharing the card over gloo, on a (data 1,
    stage 2) and a (data 1, seq 2) mesh, each check timed: (m1)
    ``pipeline_text_encode`` with the ``basic`` encoder (12 layers a stage)
    over (d)'s 3000 sentences in (d)'s static batches of 8192 tokens, int8
    and bf16, 2 microbatches a batch: equal bit for bit to the single
    rank's stack run microbatch by microbatch, cosine >= 0.999 per
    sentence against (d), #2 and #3 (int8), #1 and #5 (bf16) launched on
    each rank; ``pipeline_speech_encode`` with the ``english`` Conformer in
    bf16 over (e)'s 32 clips of 3-40 s (S up to 1999) in (e)'s batches of
    8: the same checks against (e), #6 launched; (m2)
    ``sequence_speech_encode`` in bf16 and fp32 on 4 of (e)'s clips, two of
    45-50 s, at S 2500 (1250 frames a rank), against the single-rank encode
    (cosine >= 0.999 per clip in bf16, max-abs <= 1e-3 of the scale in
    fp32), each rank's peak device memory beside the single rank's; (m3)
    one fp32 backward of each (the text and speech encoders cut to 2
    layers, full width; the sum of the squared embeddings) against the
    single rank's: the loss within 1e-5, every leaf the rank holds within
    (k4)'s 2e-3 of its scale, no launch.

(n) each path with its kernels off (``ops.gates.no_cuda_kernels``), on the
    models and weights of (d)-(h2), run once with its kernels and once
    inside the scope: int8 text at [64, 128] (#2, #3 with LN) and [16, 512]
    (#2 with #5's core as its attention step, #3 with LN), bf16 text at
    [8, 128] (#1), the int8 [16, 512] batch under
    ``set_attention_impl("plain")`` (#3 alone; neither #2 nor flash may
    launch), int8 text with q/k/v unfused at [16, 512] (#5, #3 alone), a bf16
    encoder with q/k/v unfused at [64, 64] under
    ``set_attention_impl("cuda")`` (flash below its length gate), bf16
    speech on 8 clips of 20 s (S 999, #6), fp32 beam decode (#8) and fp32
    top-k 10 sampling from seed 7 (``gumbel_max``) on the graph path at B
    32, each decode on a fresh runtime over (f)'s model. Each path: its
    kernels launched without the scope, none inside it (capture tallies
    included); the outputs within PERF.md's agreement limits (cosine >=
    0.999 per sentence or clip; fp32 best hypotheses equal but in a tie
    within 1e-5; sampled tokens identical); device ms of a batch (5 text
    batches, 2 speech, behind a GPU spin of ~0.4 s) or of a decode step (2 decodes)
    each way, beside the card's name and power limit. The decodes run
    outside, inside, outside: two captures, keyed on the scope, and the
    third decode replays the first's graph, equal bit for bit.

A kernel's ``launches`` in the JSON record is the sum of its counts over
(d) to (m) (with (f2) and (h2)), (l)'s and (m)'s summed over their
children ((n)'s are logged, not summed); the kernels that no path calls (``relpos_flash_attention``,
``beam_diag_attend``, ``beam_reorder_attend``,
``fused_bf16_ffn_ln_residual``) must read 0. Prints that record on the
line before the last, and as the last line ``{"ok": true, "device":
{...}}``. Any failure raises (exit != 0).
"""

from __future__ import annotations

import argparse
import functools
import itertools
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
RELPOS_REPEATS = 16  # calls of the rel-pos v2 kernel on one input, held equal bit for bit
BEAM_REPEATS = 16  # calls of beam_masked_attend at the long cache, held equal bit for bit
DIAG_REPEATS = 16  # calls of beam_diag_attend on one input, held equal bit for bit
# rel-pos v2 in fp32 at [8, 16, 499, 64] on an NVIDIA H100 80GB HBM3 at 700 W
# before its last launch (the fp32 v1 kernel) was last edited: its time
# there may not exceed this by more than the spread between runs and cards,
# taken as 10%.
RELPOS_V2_F32_MS, SPREAD = 2.9114, 0.10

KERNELS = {  # name -> (CUDA source, TPU kernel it replaces, wrapper module, its launch count)
    "short_qkv_attention": ("sonar_tpu_torch/csrc/short_attn.cu",
                            "sonar_tpu/ops/pallas/short_attn.py:59", "short_attn", "LAUNCHES"),
    "fused_attn_block": ("sonar_tpu_torch/csrc/attn_block.cu",
                         "sonar_tpu/ops/pallas/attn_block.py:106", "attn_block", "LAUNCHES"),
    "fused_int8_ffn": ("sonar_tpu_torch/csrc/ffn.cu",
                       "sonar_tpu/ops/pallas/ffn.py:206", "ffn", "LAUNCHES"),
    "flash_attention": ("sonar_tpu_torch/csrc/flash.cu",
                        "sonar_tpu/ops/pallas/flash.py:52", "flash", "LAUNCHES"),
    "relpos_flash_attention_v2": ("sonar_tpu_torch/csrc/relpos_flash.cu",
                                  "sonar_tpu/ops/pallas/relpos_flash.py:91", "relpos_flash",
                                  "LAUNCHES"),
    "relpos_flash_attention": ("sonar_tpu_torch/csrc/relpos_flash.cu",
                               "sonar_tpu/ops/pallas/relpos_flash.py:172", "relpos_flash",
                               "V1_LAUNCHES"),
    "beam_masked_attend": ("sonar_tpu_torch/csrc/beam_masked.cu",
                           "sonar_tpu/ops/pallas/beam_attend.py:71", "beam_attend",
                           "MASKED_LAUNCHES"),
    "beam_diag_attend": ("sonar_tpu_torch/csrc/beam_diag.cu",
                         "sonar_tpu/ops/pallas/beam_attend.py:141", "beam_attend",
                         "DIAG_LAUNCHES"),
    "beam_reorder_attend": ("sonar_tpu_torch/csrc/beam_reorder.cu",
                            "sonar_tpu/ops/pallas/beam_attend.py:225", "beam_attend",
                            "REORDER_LAUNCHES"),
    "fused_bf16_ffn_ln_residual": ("sonar_tpu_torch/csrc/bf16_ffn.cu",
                                   "sonar_tpu/ops/pallas/ffn.py:137", "ffn", "BF16_LAUNCHES"),
    # No Pallas kernel: the sampling step's jax.random.categorical, which XLA
    # computes in the JAX package.
    "gumbel_max": ("sonar_tpu_torch/csrc/gumbel_max.cu", "sonar_tpu/generation/sampling.py:123",
                   "gumbel_max", "LAUNCHES"),
    # No Pallas kernel: the Conformer block's residual adds and LayerNorms,
    # which XLA fuses in the JAX package.
    "add_layer_norm": ("sonar_tpu_torch/csrc/add_layer_norm.cu",
                       "sonar_tpu/nn/conformer.py:353", "layer_norm", "LAUNCHES"),
}
# Kernels that no driven path launches (no JAX path calls them either): their
# counts are read like the others' and must stay 0.
NO_PATH = ("relpos_flash_attention", "beam_diag_attend", "beam_reorder_attend",
           "fused_bf16_ffn_ln_residual")

# The card's published peaks (NVIDIA H100 SXM data sheet, dense): device
# memory bytes/s and operations/s by operand type. A kernel's bound is the
# larger of its bytes over HBM and its operations over their peaks. 32-bit
# integer operations (not on the data sheet): the Hopper white paper's 64
# INT32 lanes an SM, 132 SMs, at the 1.98 GHz behind the data sheet's fp32
# rate (67e12 = 132 x 128 lanes x 2 x 1.98e9).
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12, "int32": 132 * 64 * 1.98e9}
SAMPLE_VOCAB = 256206  # the basic decoder's vocabulary: (c)'s gumbel_max shape


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


def _counter(name: str):
    import importlib

    _, _, module, attr = KERNELS[name]
    return importlib.import_module(f"sonar_tpu_torch.ops.cuda.{module}"), attr


def zero_launches() -> None:
    """Set every kernel's launch count to 0 (just before a driven path)."""
    for name in KERNELS:
        setattr(*_counter(name), 0)


def read_launches() -> dict:
    """Every kernel's launch count (just after a driven path)."""
    return {name: getattr(*_counter(name)) for name in KERNELS}


# -- (a) setup -------------------------------------------------------------------


def setup():
    if not (REPO / "sonar_tpu_torch").is_dir():
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


def _timed(torch, fn, iters: int, spin: int = 50_000_000) -> float:
    """Device ms per call of ``fn``. The calls are queued behind a spin of
    the GPU (``spin`` cycles, ~25 ms by default), so the events bracket
    device work only (a kernel of a few microseconds would otherwise be
    timed at the host's launch rate)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _timed_cold(torch, fn, iters: int) -> float:
    """Device ms of one call of ``fn`` with a cold L2, the median of
    ``iters``: before each call the GPU spins, then writes a 256 MB buffer
    (five times the H100's 50 MB L2); events bracket the call alone."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=DEVICE)
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in events)[iters // 2]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(moved: int, ops: dict):
    """(bound_ms, bound_by): the larger of ``moved`` bytes over HBM and the
    operations ``ops`` ({operand type: count}) over their peaks."""
    t_bytes = moved / HBM_BYTES_S
    t_ops = sum(n / PEAK_OPS_S[kind] for kind, n in ops.items())
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _kind(dtype) -> str:
    return "bf16" if str(dtype).endswith("bfloat16") else "fp32"


def _errors(torch, got, want):
    g, w = got.double().reshape(-1, got.shape[-1]), want.double().reshape(-1, want.shape[-1])
    max_abs = (g - w).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(g, w, dim=-1).min().item()
    finite = bool(torch.isfinite(g).all().item())
    return max_abs, cos, finite, w.abs().max().item()


def tree_ancestry(torch, b, beam, s, idx, gen, dev):
    """[B, K, S] int32 ancestry as beam search builds it (``generation/
    beam_search.py``): the identity, then at each of the steps 0..idx every
    beam takes a random parent's table and names its own row at the step's
    position. Lineages merge within a few steps, so most older positions
    name one row."""
    rows = torch.arange(beam, device=dev, dtype=torch.int32)
    anc = rows[None, :, None].expand(b, beam, s).contiguous()
    for t in range(idx + 1):
        parent = torch.randint(0, beam, (b, beam), generator=gen, device=dev)
        anc = torch.gather(anc, 1, parent[:, :, None].expand(b, beam, s))
        anc[:, :, t] = rows
    return anc.contiguous()


def distinct_rows(torch, anc, idx, beam):
    """The distinct (cache row, position) pairs the ancestry names up to
    the write position, summed over sentences: the rows one head must read."""
    b, _, s = anc.shape
    needed = torch.zeros(b, beam, s, dtype=torch.bool, device=anc.device)
    needed.scatter_(1, anc.long(), True)
    return int((needed & (torch.arange(s, device=anc.device) <= idx)).sum())


def relpos_bound_ops(b, h, s, dh, d) -> int:
    """Operations of the rel-shift algorithm, the least work for v2's
    function: ac, bd and P V over (S, S), and the positional projection of
    the 2S - 1 relative positions for every head."""
    return 6 * b * h * s * s * dh + 2 * h * (2 * s - 1) * d * dh


def relpos_kernel_ops(b, h, s, dh, d) -> int:
    """Operations the bf16 v2 kernels compute (``csrc/relpos_flash.cu``):
    over 64-row blocks in pairs and 128-key tiles, ac and the window
    product (128 table rows a 64-key half) in each of the two passes, P V
    once; and the distance table, 2 (2S - 1 + 128) D dh a head."""
    rows, keys = -(-s // 128) * 128, -(-s // 128) * 128
    logits = b * h * rows * keys
    return 2 * (2 * logits * dh + 4 * logits * dh) + 2 * logits * dh + 2 * h * (2 * s + 127) * d * dh


def relpos_l2_bytes(b, h, s, dh, d) -> tuple:
    """Bytes the bf16 v2 kernels move through L2, from their tiling
    (``csrc/relpos_flash.cu``): a cluster of two 64-row blocks of one head
    fetches every 128-key tile of K in both passes and of V in pass 2 once,
    multicast to both; each block reads 192 table rows a tile in both
    passes and its q rows; the output is written once. -> (those bytes,
    the table's: written once a launch, Wr_h and the trig rows read)."""
    clusters = b * h * -(-s // 128)
    blocks, tiles = 2 * clusters, -(-s // 128)
    io = (clusters * 3 * s * dh * 2 + blocks * (tiles * 2 * 192 * dh + 64 * dh) * 2
          + b * h * s * dh * 2)
    return io, h * (2 * s + 127) * dh * 2 + h * d * dh * 2 + 2 * s * d * 2


def log_relpos_work(b, h, s, dh, d, result) -> None:
    """The operation counts of v2 beside its last time, and its L2 bytes."""
    ms = result.get("last_ms")
    if ms is None:
        return
    bound_ops = relpos_bound_ops(b, h, s, dh, d)
    ops = relpos_kernel_ops(b, h, s, dh, d)
    peak = PEAK_OPS_S["bf16"]
    parts = [f"bound (rel-shift) {bound_ops / 1e9:.1f} GFLOP, {bound_ops / ms / 1e9 / peak * 1e12:.1%}"
             " of the bf16 peak"]
    parts.append(f"as computed {ops / 1e9:.1f} GFLOP, {ops / ms / 1e9 / peak * 1e12:.1%}")
    parts.append(f"{b * h * s * s / ms / 1e9:.3f}e12 logits/s")
    io, table = relpos_l2_bytes(b, h, s, dh, d)
    log(f"work relpos_flash_attention_v2 [{b},{h},{s},{dh}] at {ms:.4f} ms: " + "; ".join(parts)
        + f"; L2 traffic of the tiling {io / 1e9:.3f} GB ({io / ms / 1e9:.2f} TB/s), the table's"
        f" {table / 1e9:.3f} GB")


def check_kernels(torch):
    from sonar_tpu_torch.nn.conformer import _trig_tables
    from sonar_tpu_torch.ops.cuda import (
        attn_block,
        beam_attend,
        ffn,
        flash,
        relpos_flash,
        short_attn,
    )
    from sonar_tpu_torch.ops.quantization import quantize_kernel

    F = torch.nn.functional

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

    # The bf16 attention core divides P by the row sum with __fdiv_rn's fast
    # path and the reciprocal hoisted out (csrc/attention.cuh, tc_normalise):
    # held to __fdiv_rn bit for bit over 2^36 operand pairs of a softmax
    # row's range (csrc/div_check.cu).
    from sonar_tpu_torch.ops import _build

    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    _build.check(_build.library().sonar_check_softmax_division(
        2 ** 34, 12345, counts.data_ptr(), _build.stream_of(counts)), "softmax division check")
    pairs, differ, differ_fast = counts.tolist()
    ok = differ == 0 and differ_fast == 0
    log(f"check softmax division against __fdiv_rn: {pairs} operand pairs, {differ} differ "
        f"(tc_div alone: {differ_fast} with a numerator >= 2^-100) in "
        f"{time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("softmax division")

    def check(name, label, kernel_fn, plain_fn, rtol, min_cos, timed=False, cost=None,
              library_fn=None, pick=lambda out: out, atol=None):
        """Pass if max|kernel - plain| <= rtol * max|plain| (or <= atol when
        given) and every row's cosine >= min_cos, all values finite (on
        ``pick`` of the outputs). A timed call also times ``library_fn`` (one
        PyTorch call of the same function, or None) and computes the bound
        from ``cost`` = (bytes, {operand type: operations}) of these inputs."""
        got, want = pick(kernel_fn()), pick(plain_fn())
        torch.cuda.synchronize()
        max_abs, cos, finite, ref = _errors(torch, got, want)
        limit = rtol * ref if atol is None else atol
        ok = finite and max_abs <= limit and cos >= min_cos
        log(f"check {name} {label}: max_abs {max_abs:.3e} (<= "
            f"{f'{rtol:.0e} x ref max {ref:.3g}' if atol is None else f'{atol:.0e}'}) "
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
            lib = _timed(torch, library_fn, iters) if library_fn is not None else None
            bound_ms, bound_by = bound(*cost)
            if "ms" not in results[name]:  # the kernels line gives the first timed shape
                results[name].update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                                     bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
                                     shape=label)
            lib_s = "none" if lib is None else f"{lib:.4f} ms"
            k_ms = (k1 + k2) / 2
            results[name]["last_ms"] = k_ms
            log(f"time {name} {label}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} "
                f"ms, library call {lib_s}, bound {bound_ms:.4f} ms ({bound_by}); achieved "
                f"{sum(cost[1].values()) / k_ms / 1e9:.1f} T op/s, {bound_ms / k_ms:.1%} of the "
                f"bound")

    # Tolerances: fp32 attention agrees up to summation order (1e-5 of the
    # output scale); in bf16 an output may move by a few bf16 ulps where a
    # rounding of P or of the output flips (1e-2 of the scale, row cosine
    # >= 0.9999).
    # K1: short attention on the fused QKV layout.
    for b, s in ((64, 128), (1024, 8), (256, 32)):
        bias = key_bias(b, s)
        for dt, atol, mc in ((bf16, 1e-2, 0.9999), (f32, 1e-5, 0.999999)):
            qkv = rand(b, s, 3 * 1024, scale=0.5, dtype=dt)
            q4, k4, v4 = (t.reshape(b, s, 16, 64).transpose(1, 2) for t in qkv.split(1024, -1))
            check("short_qkv_attention", f"[{b},{s},3072] {str(dt)[6:]}",
                  lambda: short_attn.short_qkv_attention(qkv, bias, 16),
                  lambda: short_attn.short_qkv_attention_plain(qkv, bias, 16),
                  atol, mc, timed=dt == bf16,
                  cost=(nbytes(qkv, bias) + b * s * 1024 * qkv.element_size(),
                        {_kind(dt): 4 * b * 16 * s * s * 64}),
                  library_fn=lambda: F.scaled_dot_product_attention(
                      q4, k4, v4, attn_mask=bias[:, None, None, :].to(dt)))

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
                  int8_tol[dt], 0.9999, timed=(b, s, dt) == (64, 128, bf16),
                  cost=(2 * nbytes(x) + nbytes(*blk[1:10]),
                        {"int8": 2 * b * s * d * 4 * d, _kind(dt): 4 * b * 16 * s * s * 64}))

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
                      int8_tol[dt], 0.9999, timed=ln and dt == bf16,
                      cost=(2 * nbytes(x) + nbytes(w1, s1, b1, w2, s2, b2, *lnp),
                            {"int8": 2 * 2 * x.shape[0] * d * f}))
            if not split_scales and dt == bf16:
                # Yardstick only (the port never calls it): torch._int_mm on
                # the two GEMMs' pre-quantised operands, x_q @ W1 and
                # h_q @ W2, which the kernel runs on its wgmma core.
                xq = torch.randint(-127, 128, (x.shape[0], d), generator=gen, device=dev,
                                   dtype=torch.int8)
                hq = torch.randint(-127, 128, (x.shape[0], f), generator=gen, device=dev,
                                   dtype=torch.int8)
                mm1 = _timed(torch, lambda: torch._int_mm(xq, w1), 20)
                mm2 = _timed(torch, lambda: torch._int_mm(hq, w2), 20)
                ops = 2 * x.shape[0] * d * f
                log(f"time fused_int8_ffn yardstick torch._int_mm M={x.shape[0]}: "
                    f"[{x.shape[0]},{d}]x[{d},{f}] {mm1:.4f} ms ({ops / mm1 / 1e9:.1f} T op/s), "
                    f"[{x.shape[0]},{f}]x[{f},{d}] {mm2:.4f} ms ({ops / mm2 / 1e9:.1f} T op/s); "
                    f"both GEMMs at the int8 peak {2 * ops / PEAK_OPS_S['int8'] * 1e3:.4f} ms")
                del xq, hq
                # The kernel's four launches with the LayerNorm, by device
                # time (torch.profiler, 10 calls).
                prof, _, _ = _device_profile(torch, lambda: [
                    ffn._fused_ffn_impl(x, w1, s1, b1, w2, s2, b2, ln_w, ln_b, 2)
                    for _ in range(10)])
                for name, (ms, n) in sorted(prof.items(), key=lambda kv: -kv[1][0]):
                    log(f"time fused_int8_ffn M={x.shape[0]} step {ms / n:.4f} ms x{n} {name[:70]}")
        if split_scales:  # the case must tell the two kinds of scale apart
            one, two = (ffn.fused_ffn_plain(x, w1, s1, b1, w2, s2, b2, None, None, n)
                        for n in (1, 2))
            gap, _, _, ref = _errors(torch, one, two)
            log(f"fused_int8_ffn halves 8x apart: one scale per row instead of per (row, "
                f"half) moves the output by {gap:.3e} (ref max {ref:.3g})")
            if gap <= int8_tol[f32] * ref:
                failures.append("fused_int8_ffn split-scale case does not discriminate")

    # K11: the Conformer half-FFN x + 0.5 * (SiLU(LN(x) @ W1 + b1) @ W2 + b2),
    # which no path calls: at the full-width ``english`` encoder's shape (the
    # S 499 batch of phase (e): M 3992, D 1024, F 4096, 2 splits) and at the
    # JAX test's (M 300, D 128, F 512; 1, 2 and 4 splits, a ragged M), bf16
    # and fp32, weights at Kaiming scale. fp32 to max-abs 2e-4 (the JAX
    # test's tolerance: products summed in another order); bf16 to 2^-7 of
    # the output scale (one bf16 ulp of the largest value: a rounding of the
    # inner activation or the output may flip), row cosine >= 0.9999. The
    # port's eager Conformer branch (``nn/conformer.py``) is timed beside it.
    from sonar_tpu_torch.nn.conformer import _half_ffn
    from sonar_tpu_torch.nn.core import layer_norm

    for m, dm, fm, splits in ((3992, 1024, 4096, (2,)), (300, 128, 512, (1, 2, 4))):
        lnp = {"weight": 1 + rand(dm, scale=0.1), "bias": rand(dm, scale=0.1)}
        w1, b1 = rand(dm, fm, scale=dm ** -0.5), rand(fm, scale=0.1)
        w2, b2 = rand(fm, dm, scale=fm ** -0.5), rand(dm, scale=0.1)
        for dt in (bf16, f32):
            x = rand(m, dm, dtype=dt)
            w1d, w2d = w1.to(dt), w2.to(dt)  # a model of dtype dt stores its weights so
            fargs = (x, lnp["weight"], lnp["bias"], w1d, b1, w2d, b2, 0.5)
            kind = str(dt)[6:]
            for n in splits:
                timed = n == 2
                check("fused_bf16_ffn_ln_residual", f"M={m} D={dm} F={fm} splits={n} {kind}",
                      lambda: ffn.fused_bf16_ffn_ln_residual(*fargs, n_splits=n),
                      lambda: ffn.fused_bf16_ffn_ln_residual_plain(*fargs, n_splits=n),
                      2.0 ** -7, 0.9999, timed=timed, atol=2e-4 if dt == f32 else None,
                      cost=(2 * nbytes(x) + nbytes(w1d, w2d, b1, b2, lnp["weight"], lnp["bias"]),
                            {_kind(dt): 4 * m * dm * fm}))
            branch = {"inner_proj": {"kernel": w1d, "bias": b1.to(dt)},
                      "output_proj": {"kernel": w2d, "bias": b2.to(dt)}}
            eager = _timed(torch, lambda: x + 0.5 * _half_ffn(branch, layer_norm(lnp, x)), 20)
            kernel_ms = results["fused_bf16_ffn_ln_residual"].get("last_ms")
            log(f"time fused_bf16_ffn_ln_residual M={m} D={dm} F={fm} {kind}: the port's eager "
                f"Conformer branch (x + 0.5 * _half_ffn(LN(x))) {eager:.4f} ms, the kernel "
                f"{kernel_ms:.4f} ms ({eager / kernel_ms:.2f}x)")
            if m == 3992 and dt == bf16:
                # Yardstick only (the port never calls it): torch.matmul on the
                # two GEMMs' bf16 operands, LN(x) @ W1 and h @ W2 (all of F),
                # which the kernel runs on its TMA + wgmma core; then the
                # kernel's three launches by device time (torch.profiler, 10
                # calls).
                ln_x = layer_norm(lnp, x)
                hid = F.silu(ln_x @ w1d)
                mm1 = _timed(torch, lambda: torch.matmul(ln_x, w1d), 20)
                mm2 = _timed(torch, lambda: torch.matmul(hid, w2d), 20)
                ops = 2 * m * dm * fm
                log(f"time fused_bf16_ffn_ln_residual yardstick torch.matmul M={m}: "
                    f"[{m},{dm}]x[{dm},{fm}] {mm1:.4f} ms ({ops / mm1 / 1e9:.1f} TFLOP/s), "
                    f"[{m},{fm}]x[{fm},{dm}] {mm2:.4f} ms ({ops / mm2 / 1e9:.1f} TFLOP/s); "
                    f"both GEMMs at the bf16 peak {2 * ops / PEAK_OPS_S['bf16'] * 1e3:.4f} ms")
                prof, _, _ = _device_profile(torch, lambda: [
                    ffn.fused_bf16_ffn_ln_residual(*fargs, n_splits=2) for _ in range(10)])
                for name, (ms, n) in sorted(prof.items(), key=lambda kv: -kv[1][0]):
                    log(f"time fused_bf16_ffn_ln_residual M={m} step {ms / n:.4f} ms x{n} "
                        f"{name[:70]}")
                del ln_x, hid

    # K2: flash attention. P is normalised before its rounding to the value
    # dtype in both versions (as in the TPU kernel), so the tolerances are
    # those of K1.
    for s in (512, 384, 256):
        q, k, v = (rand(16, 16, s, 64, dtype=bf16) for _ in range(3))
        kb = key_bias(16, s)[:, None, None, :]
        check("flash_attention", f"[16,16,{s},64] bf16 key-bias",
              lambda: flash.flash_attention(q, k, v, kb),
              lambda: flash.flash_attention_plain(q, k, v, kb),
              1e-2, 0.9999, timed=True,
              cost=(2 * nbytes(q) + nbytes(k, v, kb), {"bf16": 4 * 16 * 16 * s * s * 64}),
              library_fn=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=kb.to(bf16)))
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

    # K5 / K6: Conformer rel-pos attention, v2 building bd inside the kernel
    # and v1 reading it. Inputs at the model's scales: q, k, v ~ N(0, 1),
    # Wr_h ~ N(0, 1/D) with D 1024, biases ~ N(0, 0.01), the trig tables
    # in the model dtype; the key bias holds a padding row of length 0
    # (B > 1) or a ragged edge (B = 1). Tolerances as for K1 and K2.
    def relpos_args(b, h, s, dh, dt):
        d = 1024
        q, k, v = (rand(b, h, s, dh, dtype=dt) for _ in range(3))
        wr = rand(h, d, dh, scale=d ** -0.5, dtype=dt)
        u, vb = rand(h, dh, scale=0.1, dtype=dt), rand(h, dh, scale=0.1, dtype=dt)
        si, ci, basis = _trig_tables(s, d, dt, dev)
        lens = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
        lens[0] = s if b > 1 else s - 37
        if b > 1:
            lens[-1] = 0
        kb = torch.where(torch.arange(s, device=dev)[None, :] < lens[:, None], 0.0, F32_MIN)
        return q, k, v, wr, si, ci, basis, u, vb, kb.float()

    tol = {bf16: (1e-2, 0.9999), f32: (1e-5, 0.999999)}
    # Timed: S 499 in bf16, then fp32; the speech cell's batches [16, 16, S,
    # 64] at S 199, 999, 1999; S 1999 at B 8 and S 2499.
    for b, h, s, dh, dt in ((8, 16, 499, 64, bf16), (8, 16, 499, 64, f32), (1, 16, 2048, 64, bf16),
                            (2, 16, 149, 64, bf16), (2, 8, 300, 128, bf16),
                            (16, 16, 199, 64, bf16), (16, 16, 999, 64, bf16),
                            (16, 16, 1999, 64, bf16),
                            (8, 16, 1999, 64, bf16), (2, 16, 2499, 64, bf16)):
        args = relpos_args(b, h, s, dh, dt)
        timed = (b, s) in ((8, 499), (16, 199), (16, 999), (16, 1999), (8, 1999), (2, 2499))
        check("relpos_flash_attention_v2", f"[{b},{h},{s},{dh}] D 1024 {str(dt)[6:]}",
              lambda: relpos_flash.relpos_flash_attention_v2(*args),
              lambda: relpos_flash.relpos_flash_attention_v2_plain(*args),
              *tol[dt], timed=timed,
              # ac, bd and P @ V over (S, S), plus the positional projection
              # of the 2S - 1 relative positions for every head
              cost=(nbytes(*args) + nbytes(args[0]),  # inputs, and the output (q's size)
                    {_kind(dt): relpos_bound_ops(b, h, s, dh, 1024)}))
        if timed and dt == bf16:
            log_relpos_work(b, h, s, dh, 1024, results["relpos_flash_attention_v2"])
        if timed and dt == f32 and s == 499:
            # fp32 v2's third launch is v1's fp32 kernel: it stays as fast.
            ms = results["relpos_flash_attention_v2"]["last_ms"]
            ok = ms <= RELPOS_V2_F32_MS * (1 + SPREAD)
            log(f"check relpos_flash_attention_v2 [8,16,499,64] float32 time: {ms:.4f} ms (<= "
                f"{RELPOS_V2_F32_MS} ms + {SPREAD:.0%}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append("relpos_flash_attention_v2 fp32 slower")
        del args
    # The bf16 kernel builds its distance table in a launch of its own and
    # shares tiles across a cluster: calls on the same inputs must give the
    # same bits, whatever the table's memory held before (NaN here).
    for b, h, s, dh in ((1, 16, 2048, 64), (2, 16, 1999, 64), (8, 16, 499, 64)):
        args = relpos_args(b, h, s, dh, bf16)
        outs = []
        for _ in range(RELPOS_REPEATS):
            # The freed NaN block is what the wrapper's table gets next.
            torch.full((h, 2 * s - 1 + relpos_flash.TABLE_PAD, dh), float("nan"), dtype=bf16,
                       device=dev)
            outs.append(relpos_flash.relpos_flash_attention_v2(*args))
        differ = sum(not torch.equal(o, outs[0]) for o in outs[1:])
        ok = differ == 0 and bool(torch.isfinite(outs[0]).all())
        log(f"check relpos_flash_attention_v2 [{b},{h},{s},{dh}] bfloat16 repeated: "
            f"{RELPOS_REPEATS} calls, {differ} differ from the first bit for bit "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"relpos_flash_attention_v2 [{b},{h},{s},{dh}] repeated")
        del args, outs
    # K7 (v1): at the speech batch's shape in bf16 (timed) and fp32 (timed: the
    # kernel of fp32 v2's third launch), and where the bf16 kernel's rows a
    # block change (64 up to S ~700, then 32, then 16: S 1999, 2048 at Dh
    # 128); every case called twice, equal bit for bit. Library call: SDPA on
    # q + u with the mask bd * Dh^-0.5 + key bias in q's dtype (built outside
    # the timed call).
    for b, h, s, dh, dt in ((8, 16, 499, 64, bf16), (8, 16, 499, 64, f32), (2, 2, 130, 64, f32),
                            (2, 16, 1999, 64, bf16), (1, 8, 2048, 128, bf16)):
        q, k, v, wr, si, ci, basis, u, vb, kb = relpos_args(b, h, s, dh, dt)
        bd = relpos_flash.relpos_bd_plain(q, wr, si, ci, basis, vb).to(dt)
        timed = (b, s) == (8, 499)
        qu = q + u[None, :, None, :] if timed else None
        mask = (bd.float() * dh ** -0.5 + kb[:, None, None, :]).to(dt) if timed else None
        label = f"[{b},{h},{s},{dh}] {str(dt)[6:]}"
        check("relpos_flash_attention", label,
              lambda: relpos_flash.relpos_flash_attention(q, k, v, bd, u, kb),
              lambda: relpos_flash.relpos_flash_attention_plain(q, k, v, bd, u, kb),
              *tol[dt], timed=timed,
              cost=(2 * nbytes(q) + nbytes(k, v, bd, u, kb), {_kind(dt): 4 * b * h * s * s * dh}),
              library_fn=lambda: F.scaled_dot_product_attention(qu, k, v, attn_mask=mask))
        first = relpos_flash.relpos_flash_attention(q, k, v, bd, u, kb)
        ok = torch.equal(relpos_flash.relpos_flash_attention(q, k, v, bd, u, kb), first)
        log(f"check relpos_flash_attention {label} repeated: 2 calls equal bit for bit "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"relpos_flash_attention {label} repeated")
        del bd, qu, mask, first

    def reorder_args(q, k, v, sel, vbias, woh):
        b, beam, h, dh = q.shape
        kn, vn = rand(b, beam, h, dh, dtype=q.dtype), rand(b, beam, h, dh, dtype=q.dtype)
        return q, kn, vn, k, v, sel, vbias, woh

    def reorder_cost(rargs):
        """K10's bound: q, this step's rows, sel, the biases and the output
        once, each distinct source slab read once, both caches written."""
        q, kn, vn, k, v, sel, vbias, woh = rargs
        b, beam, h, dh = q.shape
        n_src = sum(len(set(r)) for r in sel.tolist()) * h  # distinct slabs read
        slab = k.shape[3] * dh * k.element_size()
        return (nbytes(q, kn, vn, sel, vbias, woh, q) + 2 * n_src * slab + 2 * nbytes(k),
                {_kind(q.dtype): 4 * b * h * beam * k.shape[3] * dh})

    def reorder_held(label, rargs):
        """The new caches equal the plain version's bit for bit; a second call
        gives the same bits in all three outputs."""
        got, want = beam_attend.beam_reorder_attend(*rargs), beam_attend.beam_reorder_attend_plain(*rargs)
        again = beam_attend.beam_reorder_attend(*rargs)
        caches = torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        same = all(torch.equal(x, y) for x, y in zip(again, got))
        log(f"check beam_reorder_attend {label}: caches equal to the plain version's "
            f"{'ok' if caches else 'FAIL'}, 2 calls equal bit for bit {'ok' if same else 'FAIL'}")
        if not (caches and same):
            failures.append(f"beam_reorder_attend {label}: caches or repeat differ")

    def diag_cost(q, k, vbias, idx):
        """K9's bound: q, the bias and the output once, and each slab's rows
        up to the write position (the valid span) of K and V read once."""
        b, beam, h, dh = q.shape
        return (2 * nbytes(q) + nbytes(vbias) + 2 * b * h * beam * (idx + 1) * dh * k.element_size(),
                {_kind(q.dtype): 4 * b * h * beam * (idx + 1) * dh})

    def diag_sdpa_args(q, k, v, idx):
        """K9's library call: SDPA on 4-D tensors its fused backends take,
        each (sentence, head, beam)'s query [1, 1, Dh] against the valid
        prefix of its own row [1, idx + 1, Dh], no mask."""
        b, beam, h, dh = q.shape
        rows = b * h * beam
        q4 = q.permute(0, 2, 1, 3).reshape(rows, 1, 1, dh).contiguous()
        return (q4, k.reshape(rows, 1, k.shape[3], dh)[:, :, :idx + 1],
                v.reshape(rows, 1, k.shape[3], dh)[:, :, :idx + 1])

    def sel_of(kind, b, beam):
        if kind == "one-row":  # late in a search: every beam of a sentence names one row
            return torch.randint(0, beam, (b, 1), generator=gen, device=dev,
                                 dtype=torch.int32).expand(b, beam).contiguous()
        if kind == "identity":
            return torch.arange(beam, device=dev, dtype=torch.int32).expand(b, beam).contiguous()
        return torch.randint(0, beam, (b, beam), generator=gen, device=dev, dtype=torch.int32)

    # K8-K10: the beam-attend kernels, at the JAX kernel tests' shapes and at
    # the beam-decode shape of phase (f) (B 32, K 5, H 16, S 51, Dh 64; the
    # write position in the middle of the cache, a random ancestry), each
    # timed at the decode shape in bf16. Tolerances as for K1; the
    # reordered caches must be equal bit for bit.
    for (b, beam, h, s, dh, idx), dt in [(shape, dt) for shape in (
            (2, 5, 16, 11, 64, 5), (3, 2, 4, 7, 32, 6), (3, 5, 4, 11, 64, 4),
            (4, 5, 4, 11, 64, 6), (32, 5, 16, 51, 64, 25)) for dt in (bf16, f32)]:
        label = f"B {b} K {beam} H {h} S {s} Dh {dh} idx {idx} {str(dt)[6:]}"
        timed = (b, dt) == (32, bf16)
        q = rand(b, beam, h, dh, dtype=dt)
        k, v = rand(b, h, beam, s, dh, dtype=dt), rand(b, h, beam, s, dh, dtype=dt)
        anc = torch.randint(0, beam, (b, beam, s), generator=gen, device=dev, dtype=torch.int32)
        sel = torch.randint(0, beam, (b, beam), generator=gen, device=dev, dtype=torch.int32)
        pos = torch.arange(s, device=dev)
        vbias = torch.where(pos <= idx, 0.0, -1e30).float()
        woh = (pos == idx).float()
        qbh = q.permute(0, 2, 1, 3).reshape(b * h, beam, dh).contiguous()
        kc, vc = k.reshape(b * h, beam, s, dh), v.reshape(b * h, beam, s, dh)
        row = dh * k.element_size()
        # Rows a query needs: the distinct (cache row, position) pairs its
        # ancestry names up to the write position, for every head.
        needed = torch.zeros(b, beam, s, dtype=torch.bool, device=dev)
        needed.scatter_(1, anc.long(), True)
        n_rows = int((needed & (pos <= idx)).sum()) * h
        mask = ((anc[:, :, None, :] == torch.arange(beam, device=dev)[None, None, :, None])
                & (pos <= idx)).reshape(b, 1, beam, beam * s)
        check("beam_masked_attend", label,
              lambda: beam_attend.beam_masked_attend(qbh, kc, vc, anc, vbias, h),
              lambda: beam_attend.beam_masked_attend_plain(qbh, kc, vc, anc, vbias, h),
              *tol[dt], timed=b == 32,
              cost=(2 * nbytes(qbh) + nbytes(anc, vbias) + 2 * n_rows * row,
                    {_kind(dt): 4 * b * h * beam * (idx + 1) * dh}),
              library_fn=lambda: F.scaled_dot_product_attention(
                  q.permute(0, 2, 1, 3), k.reshape(b, h, beam * s, dh),
                  v.reshape(b, h, beam * s, dh), attn_mask=mask))
        q4, k4, v4 = diag_sdpa_args(q, k, v, idx)
        check("beam_diag_attend", label,
              lambda: beam_attend.beam_diag_attend(q, k, v, vbias),
              lambda: beam_attend.beam_diag_attend_plain(q, k, v, vbias),
              *tol[dt], timed=timed, cost=diag_cost(q, k, vbias, idx),
              library_fn=lambda: F.scaled_dot_product_attention(q4, k4, v4))
        rargs = reorder_args(q, k, v, sel, vbias, woh)
        check("beam_reorder_attend", label,
              lambda: beam_attend.beam_reorder_attend(*rargs),
              lambda: beam_attend.beam_reorder_attend_plain(*rargs),
              *tol[dt], timed=timed, pick=lambda out: out[0], cost=reorder_cost(rargs))
        reorder_held(label, rargs)
        del k, v, kc, vc, rargs

    # K10 with sel naming one row for every beam (late in a search) and the
    # identity, K 1 and 16, Dh 32 and 128, idx 0 and S - 1, and a cache of 259
    # positions (staged in chunks), against the plain version; the caches
    # equal bit for bit, two calls equal. Then K10 in bf16 timed at the decode
    # shape (random and one-row sel) and at S 259, idx 200, warm and with a
    # cold L2 (a 256 MB write before each call), beside its bound.
    for (b, beam, h, s, dh, idx), kind, dt in (
            ((32, 5, 16, 51, 64, 25), "one-row", bf16), ((32, 5, 16, 51, 64, 25), "identity", bf16),
            ((4, 1, 2, 51, 64, 25), "random", bf16), ((3, 5, 4, 51, 32, 0), "random", f32),
            ((3, 5, 4, 51, 128, 50), "one-row", bf16), ((2, 16, 2, 51, 128, 25), "random", f32),
            ((4, 5, 4, 259, 64, 200), "random", bf16), ((4, 5, 4, 259, 64, 258), "identity", f32),
            ((2, 3, 2, 259, 32, 0), "one-row", bf16)):
        label = f"B {b} K {beam} H {h} S {s} Dh {dh} idx {idx} {str(dt)[6:]} {kind} sel"
        pos = torch.arange(s, device=dev)
        rargs = reorder_args(rand(b, beam, h, dh, dtype=dt), rand(b, h, beam, s, dh, dtype=dt),
                             rand(b, h, beam, s, dh, dtype=dt), sel_of(kind, b, beam),
                             torch.where(pos <= idx, 0.0, -1e30).float(), (pos == idx).float())
        check("beam_reorder_attend", label,
              lambda: beam_attend.beam_reorder_attend(*rargs),
              lambda: beam_attend.beam_reorder_attend_plain(*rargs),
              *tol[dt], pick=lambda out: out[0])
        reorder_held(label, rargs)
        del rargs
    for (b, beam, h, s, dh, idx), kind in (((32, 5, 16, 51, 64, 25), "random"),
                                           ((32, 5, 16, 51, 64, 25), "one-row"),
                                           ((32, 5, 16, 259, 64, 200), "random")):
        pos = torch.arange(s, device=dev)
        rargs = reorder_args(rand(b, beam, h, dh, dtype=bf16), rand(b, h, beam, s, dh, dtype=bf16),
                             rand(b, h, beam, s, dh, dtype=bf16), sel_of(kind, b, beam),
                             torch.where(pos <= idx, 0.0, -1e30).float(), (pos == idx).float())
        fn = lambda: beam_attend.beam_reorder_attend(*rargs)  # noqa: E731
        bound_ms = bound(*reorder_cost(rargs))[0]
        warm, cold = _timed(torch, fn, 20), _timed_cold(torch, fn, 20)
        log(f"time beam_reorder_attend B {b} K {beam} H {h} S {s} Dh {dh} idx {idx} bfloat16 "
            f"{kind} sel: warm {warm:.4f} ms ({bound_ms / warm:.1%} of the bound), cold L2 "
            f"{cold:.4f} ms ({bound_ms / cold:.1%}); bound {bound_ms:.4f} ms (bytes)")
        del rargs

    # K9 at S 259 (a span of 201 positions, streamed in chunks), idx 0 (one
    # valid position), K 1 and 16, Dh 32 and 128, against the plain version;
    # each case again on caches holding NaN at every position past idx (never
    # read: the same bits) and called DIAG_REPEATS times on one input, every
    # output equal to the first bit for bit. Then K9 in bf16 timed at S 259,
    # idx 200, warm and with a cold L2, beside its bound and the 4-D SDPA.
    for (b, beam, h, s, dh, idx), dt in (
            ((32, 5, 16, 259, 64, 200), bf16), ((32, 5, 16, 259, 64, 200), f32),
            ((32, 5, 16, 51, 64, 0), bf16), ((32, 5, 16, 51, 64, 25), f32),
            ((4, 1, 2, 51, 64, 25), bf16), ((2, 16, 2, 51, 128, 25), f32),
            ((3, 5, 4, 51, 32, 50), bf16), ((2, 16, 4, 259, 128, 200), bf16),
            ((2, 3, 2, 259, 32, 0), f32)):
        label = f"B {b} K {beam} H {h} S {s} Dh {dh} idx {idx} {str(dt)[6:]}"
        pos = torch.arange(s, device=dev)
        q = rand(b, beam, h, dh, dtype=dt)
        k, v = rand(b, h, beam, s, dh, dtype=dt), rand(b, h, beam, s, dh, dtype=dt)
        vbias = torch.where(pos <= idx, 0.0, -1e30).float()
        check("beam_diag_attend", label,
              lambda: beam_attend.beam_diag_attend(q, k, v, vbias),
              lambda: beam_attend.beam_diag_attend_plain(q, k, v, vbias), *tol[dt])
        first = beam_attend.beam_diag_attend(q, k, v, vbias)
        past = (pos > idx)[None, None, None, :, None]
        poisoned = beam_attend.beam_diag_attend(q, k.masked_fill(past, float("nan")),
                                                v.masked_fill(past, float("nan")), vbias)
        outs = [beam_attend.beam_diag_attend(q, k, v, vbias) for _ in range(DIAG_REPEATS)]
        differ = sum(not torch.equal(o, first) for o in outs)
        ok = differ == 0 and torch.equal(poisoned, first) and bool(torch.isfinite(first).all())
        log(f"check beam_diag_attend {label}: NaN past idx gives the same bits "
            f"{torch.equal(poisoned, first)}; {DIAG_REPEATS} calls, {differ} differ from the first "
            f"bit for bit {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"beam_diag_attend {label} NaN past idx or repeated")
        if (b, s, dh, dt) == (32, 259, 64, bf16):
            fn = lambda: beam_attend.beam_diag_attend(q, k, v, vbias)  # noqa: E731
            q4, k4, v4 = diag_sdpa_args(q, k, v, idx)
            bound_ms = bound(*diag_cost(q, k, vbias, idx))[0]
            warm, cold = _timed(torch, fn, 20), _timed_cold(torch, fn, 20)
            lib = _timed(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4), 20)
            plain = _timed(torch, lambda: beam_attend.beam_diag_attend_plain(q, k, v, vbias), 20)
            log(f"time beam_diag_attend {label}: warm {warm:.4f} ms ({bound_ms / warm:.1%} of the "
                f"bound), cold L2 {cold:.4f} ms ({bound_ms / cold:.1%}); bound {bound_ms:.4f} ms "
                f"(bytes); plain {plain:.4f} ms; library call (4-D SDPA) {lib:.4f} ms")
            del q4, k4, v4
        del q, k, v, outs, first, poisoned

    # K8 at the cache of max_gen_len 256 (S 259, the write position at 200),
    # with a random ancestry and with a tree ancestry as beam search builds
    # it (most older positions name one row), bf16, timed; bound: the
    # distinct rows named up to the write position, read once. Then the
    # kernel on caches holding NaN at every position past idx and in every
    # (row, position) pair no beam names, against the plain version on the
    # clean caches; and BEAM_REPEATS calls on one input, equal bit for bit
    # (the long cache is split over blocks whose partials a second launch
    # combines).
    b, beam, h, s, dh, idx = 32, 5, 16, 259, 64, 200
    pos = torch.arange(s, device=dev)
    vbias = torch.where(pos <= idx, 0.0, -1e30).float()
    for kind in ("random", "tree"):
        q = rand(b * h, beam, dh, dtype=bf16)
        kc, vc = rand(b * h, beam, s, dh, dtype=bf16), rand(b * h, beam, s, dh, dtype=bf16)
        anc = (tree_ancestry(torch, b, beam, s, idx, gen, dev) if kind == "tree" else
               torch.randint(0, beam, (b, beam, s), generator=gen, device=dev, dtype=torch.int32))
        n_rows = distinct_rows(torch, anc, idx, beam) * h
        mask = ((anc[:, :, None, :] == torch.arange(beam, device=dev)[None, None, :, None])
                & (pos <= idx)).reshape(b, 1, beam, beam * s)
        label = f"B {b} K {beam} H {h} S {s} Dh {dh} idx {idx} bfloat16 {kind} ancestry"
        check("beam_masked_attend", label,
              lambda: beam_attend.beam_masked_attend(q, kc, vc, anc, vbias, h),
              lambda: beam_attend.beam_masked_attend_plain(q, kc, vc, anc, vbias, h),
              *tol[bf16], timed=True,
              cost=(2 * nbytes(q) + nbytes(anc, vbias) + 2 * n_rows * dh * 2,
                    {"bf16": 4 * b * h * beam * (idx + 1) * dh}),
              library_fn=lambda: F.scaled_dot_product_attention(
                  q.reshape(b, h, beam, dh), kc.reshape(b, h, beam * s, dh),
                  vc.reshape(b, h, beam * s, dh), attn_mask=mask))
        log(f"work beam_masked_attend {label}: {n_rows // h} distinct rows a head "
            f"({n_rows // h / b / (idx + 1):.2f} a position), "
            f"{2 * n_rows * dh * 2 / 1e6:.1f} MB of K and V")
        # The timing above calls the kernel back to back on one cache, whose
        # named rows may stay in L2; on the decode path a layer's rows were
        # last read a step earlier.
        bound_ms = bound(2 * nbytes(q) + nbytes(anc, vbias) + 2 * n_rows * dh * 2, {})[0]
        cold = _timed_cold(torch, lambda: beam_attend.beam_masked_attend(q, kc, vc, anc, vbias, h),
                           20)
        lib_cold = _timed_cold(torch, lambda: F.scaled_dot_product_attention(
            q.reshape(b, h, beam, dh), kc.reshape(b, h, beam * s, dh),
            vc.reshape(b, h, beam * s, dh), attn_mask=mask), 20)
        log(f"time beam_masked_attend {label}, cold L2: kernel {cold:.4f} ms, {bound_ms / cold:.1%} "
            f"of the bound {bound_ms:.4f} ms; library call {lib_cold:.4f} ms")
        named = torch.zeros(b, beam, s, dtype=torch.bool, device=dev)
        named.scatter_(1, anc.long(), True)
        named &= pos <= idx
        poison = (~named)[:, None, :, :, None].expand(b, h, beam, s, dh).reshape(kc.shape)
        kp, vp = kc.masked_fill(poison, float("nan")), vc.masked_fill(poison, float("nan"))
        check("beam_masked_attend", label + ", unnamed rows and positions past idx NaN",
              lambda: beam_attend.beam_masked_attend(q, kp, vp, anc, vbias, h),
              lambda: beam_attend.beam_masked_attend_plain(q, kc, vc, anc, vbias, h),
              *tol[bf16])
        outs = [beam_attend.beam_masked_attend(q, kc, vc, anc, vbias, h)
                for _ in range(BEAM_REPEATS)]
        differ = sum(not torch.equal(o, outs[0]) for o in outs[1:])
        ok = differ == 0 and bool(torch.isfinite(outs[0]).all())
        log(f"check beam_masked_attend {label} repeated: {BEAM_REPEATS} calls, {differ} differ "
            f"from the first bit for bit {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"beam_masked_attend {label} repeated")
        del q, kc, vc, kp, vp, outs

    # K12 (replaces no Pallas kernel): the sampling step's Gumbel-max with
    # JAX's threefry noise, at the sampling decode's [32, 256206] and at
    # [128, 256206], over 48 steps (top-p 0.9-filtered rows and whole
    # log-probability rows in turns, row0 0 to 2): the noise and the tokens
    # equal to the plain version's bit for bit (both use the same logf).
    # Timed at [32, 256206] on the filtered rows. Bound: the rows read once
    # and the tokens written, against 75 integer operations an element (the
    # threefry hash's 20 rounds of add, rotate and xor, its 6 key
    # injections, the bits' xor, shift and or) and 9 fp32 ones (the uniform,
    # two logs, two negations, the add and the comparison). No library call
    # computes this function (torch.multinomial draws other numbers).
    from sonar_tpu_torch.generation.sampling import TopPSampler
    from sonar_tpu_torch.ops.cuda import gumbel_max as gm

    key = gm.prng_key(123456, dev)
    step = torch.zeros((), dtype=torch.int64, device=dev)
    for b in (32, 128):
        lp = torch.log_softmax(rand(b, SAMPLE_VOCAB, scale=3.0), dim=-1)
        nucleus = TopPSampler(0.9).filter_logprobs(lp)
        noise, want_noise = (torch.empty(b, SAMPLE_VOCAB, device=dev) for _ in range(2))
        differ = [0, 0]
        gap = 0.0
        for s in range(48):
            step.fill_(s)
            filtered = nucleus if s % 2 else lp
            got = gm.gumbel_max(filtered, key, step, s % 3, noise=noise)
            want = gm.gumbel_max_plain(filtered, key, step, s % 3, noise=want_noise)
            differ[0] += int((noise != want_noise).sum())
            differ[1] += int((got != want).sum())
            gap = max(gap, float((noise - want_noise).abs().max()))
        ok = differ == [0, 0] and bool(torch.isfinite(noise).all())
        log(f"check gumbel_max [{b},{SAMPLE_VOCAB}] over 48 steps: {differ[0]} noise values and "
            f"{differ[1]} tokens differ from the plain version's (bit for bit) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"gumbel_max [{b},{SAMPLE_VOCAB}]")
        results["gumbel_max"]["max_abs_err"] = max(results["gumbel_max"]["max_abs_err"], gap)
        if b == 32:
            step.fill_(7)
            kernel_fn = lambda: gm.gumbel_max(nucleus, key, step)  # noqa: E731
            plain_fn = lambda: gm.gumbel_max_plain(nucleus, key, step)  # noqa: E731
            p1, k1, k2, p2 = (_timed(torch, fn, 20)
                              for fn in (plain_fn, kernel_fn, kernel_fn, plain_fn))
            n = b * SAMPLE_VOCAB
            bound_ms, bound_by = bound(nbytes(nucleus, key, step) + 8 * b,
                                       {"int32": 75 * n, "fp32": 9 * n})
            k_ms = (k1 + k2) / 2
            results["gumbel_max"].update(ms=k_ms, plain_ms=(p1 + p2) / 2, bound_ms=bound_ms,
                                         bound_by=bound_by, library_ms=None,
                                         shape=f"[{b},{SAMPLE_VOCAB}] top-p 0.9 rows")
            log(f"time gumbel_max [{b},{SAMPLE_VOCAB}]: kernel {k1:.4f} / {k2:.4f} ms, plain "
                f"{p1:.4f} / {p2:.4f} ms, library call none, bound {bound_ms:.4f} ms "
                f"({bound_by}); {bound_ms / k_ms:.1%} of the bound")
        del lp, nucleus, noise, want_noise

    # K13 (replaces no Pallas kernel): the Conformer block's residual add +
    # LayerNorm, x_out = x + s * f and ln = LN(x_out), at the speech cell's
    # batches (rows of 1,024 in bf16: M 3,184, 15,984 and 31,984, the
    # parameters in bf16 as the model stores them), with x_out (s 0.5),
    # without it, and without a branch (the block's first LN); in fp32 at
    # M 3,184. x_out equal to the eager `x + s * f` bit for bit; ln to one
    # bf16 ulp of the output scale (2^-7; fp32 1e-5: the two differ only by
    # the order of the fp32 sums), row cosine >= 0.99999. Timed beside the
    # plain version (the eager composition) and, as a yardstick only (the
    # port never calls it), torch.nn.functional.layer_norm after an add; warm
    # and with a cold L2. Bound: the bytes over 3.35 TB/s (4, 3 and 2 rows
    # of D sizeof(T)) against 10 fp32 operations an element.
    from sonar_tpu_torch.ops.cuda import layer_norm as aln

    for dt, ms in ((bf16, (3184, 15984, 31984)), (f32, (3184,))):
        dm = 1024
        lnp = {"weight": (1 + rand(dm, scale=0.1)).to(dt), "bias": rand(dm, scale=0.1).to(dt)}
        for m in ms:
            x, br = rand(m, dm, dtype=dt), rand(m, dm, dtype=dt)
            for case, branch, scale, want_sum, rows in (("x_out", br, 0.5, True, 4),
                                                        ("no x_out", br, 0.5, False, 3),
                                                        ("no branch", None, 1.0, False, 2)):
                got_sum, _ = aln.add_layer_norm(x, branch, lnp, scale, want_sum)
                eager_sum, _ = aln.add_layer_norm_plain(x, branch, lnp, scale)
                if want_sum and not torch.equal(got_sum, eager_sum):
                    failures.append(f"add_layer_norm [{m},{dm}] x_out")
                    log(f"check add_layer_norm [{m},{dm}] {str(dt)[6:]}: x_out differs from "
                        f"the eager sum FAIL")
                added = (lambda: x + scale * br) if branch is not None else (lambda: x)
                check("add_layer_norm", f"[{m},{dm}] {str(dt)[6:]} {case}",
                      lambda: aln.add_layer_norm(x, branch, lnp, scale, want_sum),
                      lambda: aln.add_layer_norm_plain(x, branch, lnp, scale, want_sum),
                      2.0 ** -7, 0.99999, timed=dt == bf16, atol=1e-5 if dt == f32 else None,
                      pick=lambda out: out[1],
                      cost=(rows * nbytes(x), {"fp32": 10 * m * dm}),
                      library_fn=lambda: F.layer_norm(added(), (dm,), lnp["weight"],
                                                      lnp["bias"], 1e-5))
                if dt == bf16:
                    cold = _timed_cold(torch, lambda: aln.add_layer_norm(
                        x, branch, lnp, scale, want_sum), 21)
                    bound_ms = rows * nbytes(x) / HBM_BYTES_S * 1e3
                    log(f"time add_layer_norm [{m},{dm}] bf16 {case} cold L2: {cold:.4f} ms, "
                        f"{bound_ms / cold:.1%} of the bound")
            del x, br

    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: {failures}")
    return results


# -- (d) the slice ----------------------------------------------------------------------


def _tokenizer(tmp: Path, rng):
    """A synthetic NLLB-style SentencePiece model: 4 specials, 6000 word
    pieces, letters; language codes are added as control symbols."""
    import numpy as np

    from sonar_tpu_torch.tokenizers.spm_proto import (
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

    text_kernels = ("short_qkv_attention", "fused_attn_block", "fused_int8_ffn",
                    "flash_attention")
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

    zero_launches()
    tput, static, static_launches = {}, {}, {}
    for mode in ("int8", "bf16"):
        before = read_launches()
        t0 = time.perf_counter()
        emb = static[mode] = gpu[mode].predict(corpus, source_lang="eng_Latn",
                                               batching="static")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        static_launches[mode] = {n: c - before[n] for n, c in read_launches().items()}
        tput[mode] = len(corpus) / dt
        if emb.shape != (len(corpus), cfg.model_dim) or not np.isfinite(emb).all():
            raise AssertionError(f"{mode}: embeddings of shape {emb.shape}, finite "
                                 f"{bool(np.isfinite(emb).all())}")
        runs[mode] = emb[ref_idx]
        if mode == "bf16":
            bf16_embeddings = emb  # phases (f) and (h) decode and score these
        stats = gpu[mode].model.stats.snapshot()
        log(f"slice {mode} static: {len(corpus)} sentences in {dt:.2f} s = {tput[mode]:.1f} "
            f"sentences/s end to end (host tokenization included), padding waste "
            f"{stats['padding_waste']}, on {card}")
    dyn = gpu["int8"].predict(ref_texts, source_lang="eng_Latn", batch_size=5)
    runs["int8 dynamic"] = dyn
    runs["fp32"] = gpu["fp32"].predict(ref_texts, source_lang="eng_Latn", batch_size=5)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"launches during the slice: {launches}")
    missing = [n for n in text_kernels if launches[n] == 0]
    if missing:
        raise AssertionError(f"the main path never launched: {missing}")

    # Encode-only rate: pre-batched, pre-tokenized corpus, static batches;
    # then the device time of one batch of 8192 padded tokens at S 128 (int8:
    # the block kernels; bf16: short_qkv_attention) and at S 512 (both:
    # flash_attention), random tokens, every row full.
    from sonar_tpu_torch.data.batcher import StaticShapeBatcher
    from sonar_tpu_torch.inference_pipelines.text import _static_len_buckets_for

    batcher = StaticShapeBatcher(pad_value=1, len_buckets=_static_len_buckets_for(
        gpu["int8"].model.max_source_len), tokens_per_batch=8192)
    tok = tokenizer.create_encoder(lang="eng_Latn")
    batches = list(batcher.batches([list(tok(t)) for t in corpus]))
    n_tok = sum(int(b.seq_lens.sum()) for b in batches)
    for mode in ("int8", "bf16"):
        enc = gpu[mode].model
        enc.encode_batches(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc.encode_batches(batches)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"slice {mode} encode only: {len(corpus) / dt:.1f} sentences/s, {n_tok / dt:.0f} "
            f"real tokens/s ({len(batches)} batches of 8192 padded tokens), on {card}")
        for s in (128, 512):
            seqs = rng.integers(4, cfg.vocab_info.size, (8192 // s, s)).astype(np.int32)
            lens = np.full((8192 // s,), s, np.int32)
            ms = _timed(torch, lambda: enc._encode(seqs, lens), 5)
            log(f"slice {mode} batch [{8192 // s}, {s}]: {ms:.3f} ms of device time per batch "
                f"(5 batches behind a GPU spin), on {card}")
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
    handoff = {"tokenizer": tokenizer, "corpus": corpus, "embeddings": bf16_embeddings[:64],
               "corpus_embeddings": bf16_embeddings, "encoder": gpu["bf16"].model,
               "tokenizer_path": tmp / "synthetic_nllb.model", "text_pipelines": gpu,
               "static_embeddings": static, "static_launches": static_launches,
               "text_params": params}
    return launches, tput, handoff


# -- (e) the speech slice -------------------------------------------------------------


def _clip(rng, seconds: float):
    """A tone (100-800 Hz) plus noise, 16 kHz."""
    import numpy as np

    n = int(seconds * 16000)
    t = np.arange(n, dtype=np.float64) / 16000.0
    wave = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 800) * t) + 0.05 * rng.standard_normal(n)
    return wave.astype(np.float32)


def _speech_traffic(rng):
    """48 clips whose length-sorted batches of 8 fall on each path: 8 of
    1-2.5 s (S <= 124, plain), 24 of 3-20 s (lognormal, median ~8 s) and 8
    of 25-40 s (the kernel, S up to 1999), 8 of 45-50 s (S 2499, plain)."""
    import numpy as np

    secs = list(rng.uniform(1.0, 2.5, 8))
    secs += list(np.clip(rng.lognormal(np.log(8.0), 0.5, 24), 3.0, 20.0))
    secs += list(rng.uniform(25.0, 40.0, 8)) + list(rng.uniform(45.0, 50.0, 8))
    rng.shuffle(secs)
    return [_clip(rng, s) for s in secs]


def run_speech(torch, card, handoff):
    import numpy as np

    from sonar_tpu_torch.assets.convert import init_speech_encoder_params, speech_encoder_from_numpy
    from sonar_tpu_torch.inference_pipelines.speech import (
        SpeechToEmbeddingModelPipeline,
        TorchSpeechEncoder,
    )
    from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs
    from sonar_tpu_torch.nn import conformer

    cfg = sonar_speech_encoder_archs.get("english")
    c = cfg.conformer
    t0 = time.perf_counter()
    params = handoff["speech_params"] = init_speech_encoder_params(cfg, seed=0)
    log(f"english speech encoder weights drawn in {time.perf_counter() - t0:.1f} s "
        f"({c.num_layers} Conformer layers, D {c.model_dim}, {c.num_heads} heads, FFN "
        f"{c.ffn_inner_dim}, depthwise kernel {c.depthwise_kernel_size}, "
        f"{cfg.num_decoder_layers}-layer {cfg.decoder_norm_order}-LN pooler)")
    rng = np.random.default_rng(0)
    clips = _speech_traffic(rng)
    audio_s = sum(w.shape[0] for w in clips) / 16000.0
    # The reference subset: one batch of three short clips (plain path, a
    # padding row) and a 10 s clip alone (the kernel, S 499).
    ref = [_clip(rng, s) for s in (2.0, 10.0, 1.5, 2.5)]

    def pipeline(dtype, device):
        model = speech_encoder_from_numpy(params, cfg, dtype, device)
        return SpeechToEmbeddingModelPipeline(TorchSpeechEncoder(model))

    launches = dict.fromkeys(KERNELS, 0)
    handoff["speech_clips"], handoff["speech_pipelines"] = clips, {}
    for mode, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        pipe = handoff["speech_pipelines"][mode] = pipeline(dtype, DEVICE)
        pipe.predict(ref, batch_size=3)  # warm: allocator, cuBLAS and cuDNN handles
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        conformer.PLAIN_CALLS = 0
        batches = pipe.model.stats.snapshot()["batches"]
        t0 = time.perf_counter()
        emb = pipe.predict(clips, batch_size=8)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts, plain = read_launches(), conformer.PLAIN_CALLS
        batches = pipe.model.stats.snapshot()["batches"] - batches
        v2 = counts["relpos_flash_attention_v2"]
        launches = {name: launches[name] + counts[name] for name in KERNELS}
        if emb.shape != (len(clips), cfg.model_dim) or not np.isfinite(emb).all():
            raise AssertionError(f"speech {mode}: embeddings of shape {emb.shape}, finite "
                                 f"{bool(np.isfinite(emb).all())}")
        handoff.setdefault("speech_embeddings", {})[mode] = emb  # phase (m) reads bf16's
        log(f"speech {mode}: {len(clips)} clips ({audio_s:.1f} s of audio) in {dt:.2f} s = "
            f"{len(clips) / dt:.2f} clips/s, RTFx {audio_s / dt:.1f} through predict, on {card}")
        log(f"speech {mode}: launches {counts}, plain-path rel-pos calls {plain}; peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if v2 == 0 or plain == 0:
            raise AssertionError(f"speech {mode}: a rel-pos path was not taken (v2 {v2}, "
                                 f"plain {plain})")
        # Every block's five residual adds + LayerNorms, in every batch.
        if counts["add_layer_norm"] != 5 * c.num_layers * batches:
            raise AssertionError(f"speech {mode}: add_layer_norm launched "
                                 f"{counts['add_layer_norm']} times over {batches} batches of "
                                 f"{c.num_layers} layers, not 5 a layer")
        on_card = pipe.predict(ref, batch_size=3)

        t0 = time.perf_counter()
        on_cpu = pipeline(dtype, "cpu").predict(ref, batch_size=3)
        cpu_s = time.perf_counter() - t0
        cos = (on_card * on_cpu).sum(1) / (np.linalg.norm(on_card, axis=1)
                                           * np.linalg.norm(on_cpu, axis=1))
        max_abs = float(np.abs(on_card - on_cpu).max())
        scale = float(np.abs(on_cpu).max())
        ok = cos.min() >= 0.999 if mode == "bf16" else max_abs <= 1e-3 * scale
        log(f"speech {mode} card vs CPU on {len(ref)} clips: min cos {cos.min():.6f}, max_abs "
            f"{max_abs:.3e} (embeddings' max-abs {scale:.3g}) {'ok' if ok else 'FAIL'} "
            f"(CPU {cpu_s:.1f} s)")
        if not ok:
            raise AssertionError(f"speech {mode}: the card disagrees with the CPU reference")
    return launches


# -- (f) embedding -> text decoding --------------------------------------------------


DECODE_KW = {"beam_size": 5, "max_gen_len": 48}
EMB_TO_TEXT = "embedding->text (64 embeddings, batch 32, beam 5, max_gen_len 48)"


def _device_profile(torch, fn):
    """Run ``fn`` under torch.profiler -> ({device op name: (ms, calls)} of
    its kernels and copies, empty if the profiler saw none; wall ms under
    the profiler; (host ms, calls) blocked in device-to-host scalar reads,
    ``aten::_local_scalar_dense``, which holds the wait for the device)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops, reads = {}, (0.0, 0)
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            ops[evt.key] = (evt.self_device_time_total / 1e3, evt.count)
        elif evt.key == "aten::_local_scalar_dense":
            reads = (evt.cpu_time_total / 1e3, evt.count)
    return ops, wall_ms, reads


def _busy_share(torch, card, label, dec, fn, top=8):
    """The device busy share of ``fn`` (one decode batch on ``dec``): the
    device time of its kernels (torch.profiler) over its wall time without
    the profiler, per decode step (the search's steps; the card's, gated
    ones included, beside them), with the device operations a step the card
    ran, the host's time blocked in device-to-host scalar reads (under the
    profiler) and the ``top`` operations by device time. -> (busy share,
    ms per decode step, {device operation: (ms, calls)} of the profiled
    run, the steps the card ran in it), or None where the profiler saw no
    device time. ``fn`` runs once first, untimed (a new shape's capture)."""
    fn()
    _zero_steps(dec)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    steps, ran = dec.decode_steps, dec.device_steps
    _zero_steps(dec)
    t0 = time.perf_counter()
    ops, prof_wall, (read_ms, n_reads) = _device_profile(torch, fn)
    prof_ran = dec.device_steps
    log(f"{label}: profiled and read in {time.perf_counter() - t0:.1f} s")
    if not ops:
        log(f"{label} busy share: the profiler saw no device time (not measured)")
        return None
    busy = sum(ms for ms, _ in ops.values())
    log(f"{label}, {steps} decode steps ({ran} run by the card): device busy {busy:.2f} ms of "
        f"{wall:.2f} ms wall ({prof_wall:.2f} ms under the profiler) = {busy / wall:.3f} busy "
        f"share; {wall / steps:.3f} ms wall, {busy / ran:.3f} ms device a step the card ran and "
        f"{(wall - busy) / steps:.3f} ms idle per decode step; "
        f"{sum(n for _, n in ops.values()) / ran:.0f} device ops a step the card ran; on {card}")
    log(f"{label} host reads: under the profiler {read_ms:.3f} ms blocked in {n_reads} "
        f"device-to-host scalar reads (aten::_local_scalar_dense), "
        f"{100 * read_ms / prof_wall:.2f}% of the profiled wall; on {card}")
    for name, (ms, n) in sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"{label} device time: {ms:9.3f} ms {100 * ms / busy:5.1f}% {n:6d} calls "
            f"{name[:90]}")
    return busy / wall, wall / steps, ops, prof_ran


def _recording(dec):
    """Wrap ``dec.materialize_beam``, where every beam decode ends (the
    async pair, ``generate_beam`` and the converters), to keep each call's
    (tokens, scores, lens); ``del dec.materialize_beam`` drops the wrapper."""
    outs = []
    materialize = dec.materialize_beam

    def materialize_beam(handle):
        out = materialize(handle)
        outs.append(out)
        return out

    dec.materialize_beam = materialize_beam
    return outs


def _zero_steps(dec):
    dec.decode_steps = dec.device_steps = 0


def _steps_line(dec):
    """The decoder's step counts since ``_zero_steps``, as a log phrase."""
    return (f"{dec.decode_steps} decode steps (the card ran {dec.device_steps}: "
            f"{dec.device_steps - dec.decode_steps} gated after the exit or before a capture)")


def _same_best(label, card, cpu, tol=1e-5):
    """Best hypotheses of the card and the CPU (tokens [B, K, T], scores,
    lens) agree, or differ only where two candidates tie within ``tol`` in
    score (printed, not failed)."""
    (ct, cs, cl), (pt, ps, pl) = card, cpu
    hyp = lambda t, n, r, k: t[r, k, : n[r, k]].tolist()
    for r in range(ct.shape[0]):
        if hyp(ct, cl, r, 0) == hyp(pt, pl, r, 0):
            continue
        in_cpu = [k for k in range(pt.shape[1]) if hyp(pt, pl, r, k) == hyp(ct, cl, r, 0)]
        in_card = [k for k in range(ct.shape[1]) if hyp(ct, cl, r, k) == hyp(pt, pl, r, 0)]
        tie = ((in_cpu and abs(ps[r, in_cpu[0]] - ps[r, 0]) <= tol)
               or (in_card and abs(cs[r, in_card[0]] - cs[r, 0]) <= tol))
        log(f"decode {label} row {r}: best hypotheses differ (card score {cs[r, 0]:.7f}, CPU "
            f"{ps[r, 0]:.7f}); {'a tie within 1e-5: not a failure' if tie else 'FAIL'}")
        if not tie:
            raise AssertionError(f"decode {label}: the card's best hypothesis of row {r} is not "
                                 f"the CPU's")


def run_decode(torch, card, handoff):
    import numpy as np

    from sonar_tpu_torch.assets.convert import init_text_decoder_params, text_decoder_from_numpy
    from sonar_tpu_torch.generation.beam_search import BeamSearchConfig
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.generation.text_converter import EmbeddingToTextConverter
    from sonar_tpu_torch.inference_pipelines.text import (
        EmbeddingToTextModelPipeline,
        TextToTextModelPipeline,
    )
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs

    cfg = sonar_text_decoder_archs.get("basic")
    n_layers = cfg.num_decoder_layers
    t0 = time.perf_counter()
    params = handoff["decoder_params"] = init_text_decoder_params(cfg, seed=0)
    log(f"basic decoder weights drawn in {time.perf_counter() - t0:.1f} s ({n_layers} layers, "
        f"D {cfg.model_dim}, {cfg.num_decoder_attn_heads} heads, FFN {cfg.ffn_inner_dim}, "
        f"vocab {cfg.vocab_info.size}, tied output projection)")
    tok, emb = handoff["tokenizer"], handoff["embeddings"]
    decoders = handoff["decoders"] = {
        mode: TorchTextDecoder(text_decoder_from_numpy(params, cfg, dtype, DEVICE))
        for mode, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32))}
    launches = dict.fromkeys(KERNELS, 0)

    def drive(label, dec, fn, n_sentences):
        outs = handoff.setdefault("beam_outputs", {})[label] = _recording(dec)
        _zero_steps(dec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_launches()
        del dec.materialize_beam  # drop the recording wrapper
        steps, ran = dec.decode_steps, dec.device_steps
        n_tok = int(sum(o[2][:, 0].sum() for o in outs))
        for name in KERNELS:
            launches[name] += counts[name]
        log(f"decode {label}: {n_sentences} sentences in {dt:.3f} s = {n_sentences / dt:.2f} "
            f"sentences/s, {n_tok / dt:.1f} generated tokens/s ({n_tok} tokens of the best "
            f"hypotheses), {_steps_line(dec)}, {dt * 1e3 / steps:.3f} ms per decode step; peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {card}")
        log(f"decode {label}: launches {counts}")
        if not (counts["beam_masked_attend"] == n_layers * ran > 0
                and counts["beam_diag_attend"] == 0 and counts["beam_reorder_attend"] == 0):
            raise AssertionError(f"decode {label}: beam_masked_attend launched "
                                 f"{counts['beam_masked_attend']} times over the card's {ran} steps "
                                 f"of {n_layers} layers; diag / reorder must read 0")
        if len(out) != n_sentences or not all(isinstance(t, str) for t in out):
            raise AssertionError(f"decode {label}: {len(out)} outputs for {n_sentences} inputs")
        return out

    for mode in ("bf16", "fp32"):
        pipe = EmbeddingToTextModelPipeline(decoders[mode], tok)
        # Warm: the allocator, cuBLAS handles, the captured beam program.
        pipe.predict(emb[:32], target_lang="eng_Latn", batch_size=32, **DECODE_KW)
        drive(f"{mode} {EMB_TO_TEXT}", decoders[mode], lambda: pipe.predict(
            emb, target_lang="eng_Latn", batch_size=32, **DECODE_KW), len(emb))
    texts = handoff["corpus"][:16]
    t2t = TextToTextModelPipeline(handoff["encoder"], decoders["bf16"], tok)
    t2t.predict(texts[:8], source_lang="eng_Latn", target_lang="eng_Latn", batch_size=8,
                **DECODE_KW)  # warm: the batch of 8's beam program
    drive("bf16 text->text (16 sentences, batch 8, beam 5, max_gen_len 48)", decoders["bf16"],
          lambda: t2t.predict(texts, source_lang="eng_Latn", target_lang="eng_Latn",
                              batch_size=8, **DECODE_KW), len(texts))

    # Device busy share over one bf16 batch of 32.
    gen_cfg = BeamSearchConfig(**DECODE_KW)
    converter = EmbeddingToTextConverter(decoders["bf16"], tok, "eng_Latn", gen_cfg)
    _busy_share(torch, card, "decode bf16 batch of 32", decoders["bf16"],
                lambda: converter.batch_convert(emb[:32]))

    # The card against the CPU port on 4 embeddings: the fp32 beam search on
    # both, then the teacher-forced logits of the CPU's best hypotheses.
    prefix = tok.create_encoder(lang="eng_Latn", mode="target").prefix_indices
    memory = emb[:4, None, :]
    t0 = time.perf_counter()
    cpu = TorchTextDecoder(text_decoder_from_numpy(params, cfg, torch.float32, "cpu"), device="cpu")
    on_cpu = cpu.generate_beam(memory, prefix, gen_cfg)
    _same_best("fp32", decoders["fp32"].generate_beam(memory, prefix, gen_cfg), on_cpu)
    lens = len(prefix) + on_cpu[2][:, 0]
    seqs = np.full((4, int(lens.max())), 1, np.int32)
    for r in range(4):
        seqs[r, :lens[r]] = list(prefix) + on_cpu[0][r, 0, : on_cpu[2][r, 0]].tolist()
    valid = np.arange(seqs.shape[1])[None, :] < lens[:, None]
    for mode, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        if mode == "bf16":
            cpu = TorchTextDecoder(text_decoder_from_numpy(params, cfg, dtype, "cpu"), device="cpu")
        want = cpu.score(seqs, lens, memory)[valid]
        got = decoders[mode].score(seqs, lens, memory)[valid]
        if mode == "fp32":
            max_abs, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
            ok = max_abs <= 1e-3 * scale
            log(f"decode fp32 card vs CPU on 4 embeddings: best hypotheses agree; teacher-forced "
                f"logits max_abs {max_abs:.3e} (<= 1e-3 x scale {scale:.3g}) "
                f"{'ok' if ok else 'FAIL'} (CPU {time.perf_counter() - t0:.1f} s)")
        else:
            cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
            ok = cos.min() >= 0.999
            log(f"decode bf16 card vs CPU on 4 embeddings: teacher-forced logits min row cos "
                f"{cos.min():.6f} (>= 0.999) {'ok' if ok else 'FAIL'} "
                f"(CPU {time.perf_counter() - t0:.1f} s)")
        if not ok:
            raise AssertionError(f"decode {mode}: the card disagrees with the CPU reference")
        del cpu
    return launches


# -- (f2) the captured beam program against the eager body ---------------------------------


STREAM_TEXTS = 256  # (f2)'s text -> text at real size: 8 batches of 32 of (d)'s corpus
NEW_KEY_GEN_LEN = 45  # (f2): a limit no earlier call used, so its first call captures
# The #8 kernel as torch.profiler names it, by dtype (bf16's long caches add
# a combining launch, which is not counted).
MASKED_KERNEL = {"bf16": "beam_masked_kernel", "fp32": "beam_attend_kernel"}


def run_graph_vs_eager(torch, card, handoff):
    """(f2): beam decode through the captured CUDA graphs and the loop on
    the card (``generate_beam``) against the same search run eagerly on the
    card (``_beam_eager``, the same body, setup and tail, the same padded
    batch), on (f)'s 64 embeddings in batches of 32, in bf16, fp32 and int8
    (``quantize=True``, bf16 activations): tokens and lengths identical,
    scores bit for bit (or within 1e-5, the gap printed, where cuBLAS picks
    another algorithm under capture); each path's sentences/s, ms per
    decode step and the steps the card ran. Then, in bf16: the first call
    of a new key (its capture) timed against the next (a replay), with the
    memory it holds; each path's busy share over one batch, and the graph
    path's #8 launches counted in its torch.profiler trace, which must be 24
    x the steps the card ran; text -> text at real size (256 sentences of
    (d)'s corpus, batch 32): sequential ``batch_translate``,
    ``translate_stream`` with windows 1 and 2 (in turns: each twice) and
    ``TextToTextModelPipeline.predict``, all equal."""
    import dataclasses

    import numpy as np

    from sonar_tpu_torch.generation.beam_search import BeamSearchConfig
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.generation.text_converter import TextTranslator
    from sonar_tpu_torch.inference_pipelines.text import TextToTextModelPipeline
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs

    n_layers = sonar_text_decoder_archs.get("basic").num_decoder_layers
    tok, emb, decoders = handoff["tokenizer"], handoff["embeddings"], handoff["decoders"]
    prefix = list(tok.create_encoder(lang="eng_Latn", mode="target").prefix_indices)
    gen_cfg = BeamSearchConfig(**DECODE_KW)
    launches = dict.fromkeys(KERNELS, 0)

    def counted(fn):
        zero_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = read_launches()
        for name in KERNELS:
            launches[name] += counts[name]
        return out, counts

    int8 = TorchTextDecoder(decoders["bf16"].model, quantize=True)
    for mode, dec in (("bf16", decoders["bf16"]), ("fp32", decoders["fp32"]), ("int8", int8)):
        search = dec._search_config(gen_cfg, len(prefix))
        dec.generate_beam(emb[:32, None, :], prefix, gen_cfg)  # warm: int8's capture
        outs = {}
        for path in ("graph", "eager"):
            def run():
                res = []
                for i in range(0, len(emb), 32):
                    mem = emb[i:i + 32, None, :]
                    res.append(dec.generate_beam(mem, prefix, gen_cfg) if path == "graph" else
                               dec._beam_eager(torch.as_tensor(mem, device=DEVICE), prefix,
                                               search))
                return res

            _zero_steps(dec)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[path], counts = counted(run)
            dt = time.perf_counter() - t0
            log(f"(f2) {mode} {path}: {len(emb)} sentences in {dt:.3f} s = {len(emb) / dt:.2f} "
                f"sentences/s, {dt * 1e3 / dec.decode_steps:.3f} ms per decode step; "
                f"{_steps_line(dec)}; on {card}")
            if counts["beam_masked_attend"] != n_layers * dec.device_steps:
                raise AssertionError(f"(f2) {mode} {path}: beam_masked_attend launched "
                                     f"{counts['beam_masked_attend']} times over the card's "
                                     f"{dec.device_steps} steps")
        graph, eager = outs["graph"], outs["eager"]
        same_hyp = all(np.array_equal(g[j], e[j]) for g, e in zip(graph, eager) for j in (0, 2))
        gap = max(float(np.abs(g[1] - e[1]).max()) for g, e in zip(graph, eager))
        bits = same_hyp and gap == 0.0
        ok = same_hyp and gap <= 1e-5
        log(f"(f2) {mode} graph vs eager body on {len(emb)} embeddings: tokens and lengths "
            f"{'identical' if same_hyp else 'DIFFER'}, scores max gap {gap:.3e} "
            f"({'bit for bit' if bits else 'not bit for bit; limit 1e-5'}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"(f2) {mode}: the captured program disagrees with the eager body")
    del int8
    torch.cuda.empty_cache()

    # The cost of a capture: the first call of a new key against the next.
    dec = decoders["bf16"]
    new_key = dataclasses.replace(gen_cfg, max_gen_len=NEW_KEY_GEN_LEN)
    mem = emb[:32, None, :]
    ms, got = [], []
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    for _ in range(2):
        _zero_steps(dec)
        t0 = time.perf_counter()
        got.append(dec.generate_beam(mem, prefix, new_key))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if len(ms) == 1:
            held = (torch.cuda.memory_allocated() - held[0],
                    torch.cuda.memory_reserved() - held[1])
    line = _steps_line(dec)
    eager = dec._beam_eager(torch.as_tensor(mem, device=DEVICE), prefix,
                            dec._search_config(new_key, len(prefix)))
    same = all(np.array_equal(g, e) for out in got for g, e in zip(out, eager))
    log(f"(f2) bf16 max_gen_len {NEW_KEY_GEN_LEN}, batch of 32 (a new key): first call "
        f"{ms[0]:.1f} ms (the capture: an eager setup and step, the setup and the step "
        f"captured, the loop instantiated; then the decode), the next {ms[1]:.1f} ms (a replay, "
        f"{line}): the capture costs {ms[0] - ms[1]:.1f} ms; the new graph holds "
        f"{held[0] / 2**30:.3f} GiB allocated, {held[1] / 2**30:.3f} GiB more reserved; both "
        f"calls equal to the eager body bit for bit {same} {'ok' if same else 'FAIL'}; on {card}")
    if not same:
        raise AssertionError("(f2): a new key's captured program disagrees with the eager body")

    search = dec._search_config(gen_cfg, len(prefix))
    for path, fn in (("graph", lambda: dec.generate_beam(mem, prefix, gen_cfg)),
                     ("eager body", lambda: dec._beam_eager(torch.as_tensor(mem, device=DEVICE),
                                                            prefix, search))):
        res = _busy_share(torch, card, f"(f2) decode bf16 batch of 32, {path}", dec, fn, top=5)
        if path != "graph":
            continue
        if res is None:
            raise AssertionError("(f2): the profiler saw no device time on the graph path")
        _, _, ops, ran = res
        seen = sum(n for name, (_, n) in ops.items() if MASKED_KERNEL["bf16"] in name)
        ok = seen == n_layers * ran > 0
        log(f"(f2) graph path under torch.profiler: {seen} {MASKED_KERNEL['bf16']} launches "
            f"traced over the {ran} steps the card ran ({n_layers} x {ran} = {n_layers * ran}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("(f2): the trace does not show 24 #8 launches a step the card "
                                 "ran on the graph path")

    texts = handoff["corpus"][:STREAM_TEXTS]
    chunks = [texts[i:i + 32] for i in range(0, len(texts), 32)]
    translator = TextTranslator(handoff["encoder"], dec, tok, "eng_Latn", "eng_Latn", gen_cfg)
    translator.batch_translate(chunks[0])  # warm: the encoder's buckets of a batch of 32
    runs = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = counted(fn)
        runs.setdefault(label, []).append(time.perf_counter() - t0)
        return out

    want = timed("sequential", lambda: [translator.batch_translate(c) for c in chunks])
    for window in (1, 2, 2, 1):
        got = timed(f"window {window}",
                    lambda: list(translator.translate_stream(iter(chunks), window=window)))
        if got != want:
            raise AssertionError(f"(f2) translate_stream window {window} differs from "
                                 f"sequential batch_translate")
    if timed("sequential", lambda: [translator.batch_translate(c) for c in chunks]) != want:
        raise AssertionError("(f2) sequential batch_translate is not repeatable")
    t2t = TextToTextModelPipeline(handoff["encoder"], dec, tok)
    for _ in range(2):
        got = timed("predict", lambda: t2t.predict(texts, source_lang="eng_Latn",
                                                   target_lang="eng_Latn", batch_size=32,
                                                   **DECODE_KW))
        if got != [t for c in want for t in c]:
            raise AssertionError("(f2) TextToTextModelPipeline.predict differs from sequential "
                                 "batch_translate")
    rates = {k: [round(len(texts) / t, 2) for t in v] for k, v in runs.items()}
    log(f"(f2) text->text bf16 at real size ({len(texts)} sentences of (d)'s corpus, "
        f"{len(chunks)} batches of 32, beam 5, max_gen_len 48): translate_stream windows 1 and 2 "
        f"and predict (window 2) equal to sequential batch_translate; sentences/s of each run "
        f"(run in the order sequential, window 1, 2, 2, 1, sequential, predict, predict): "
        f"{rates}; on {card}")
    return launches


# -- (g) speech -> text ------------------------------------------------------------------


def _cos_rows(a, b):
    import numpy as np

    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def run_speech_to_text(torch, card, handoff):
    import numpy as np

    from sonar_tpu_torch.assets.convert import speech_encoder_from_numpy, text_decoder_from_numpy
    from sonar_tpu_torch.generation.beam_search import BeamSearchConfig
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.generation.text_converter import EmbeddingToTextConverter
    from sonar_tpu_torch.inference_pipelines.speech import (
        SpeechToTextModelPipeline,
        TorchSpeechEncoder,
    )
    from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs

    cfg = sonar_speech_encoder_archs.get("english")
    dcfg = sonar_text_decoder_archs.get("basic")
    n_layers = dcfg.num_decoder_layers
    tok, dec = handoff["tokenizer"], handoff["decoders"]["bf16"]
    rng = np.random.default_rng(1)
    # 16 clips in arrival order (the pipeline keeps it): 8 of 3-20 s, then 8
    # of 25-40 s, so that the two batches of 8 take S 299-999 and 1249-1999,
    # all through the v2 kernel.
    secs = list(np.clip(rng.lognormal(np.log(8.0), 0.5, 8), 3.0, 20.0))
    secs += list(rng.uniform(25.0, 40.0, 8))
    clips = [_clip(rng, x) for x in secs]
    audio_s = sum(secs)
    enc = TorchSpeechEncoder(speech_encoder_from_numpy(handoff["speech_params"], cfg,
                                                       torch.bfloat16, DEVICE))
    pipe = SpeechToTextModelPipeline(enc, dec, tok)
    pipe.predict(clips[:2], target_lang="eng_Latn", batch_size=8, beam_size=5,
                 max_gen_len=4)  # warm the encoder (the decoder's batch of 8 is (f)'s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, len(clips), 8):  # the encoder alone on the same batches
        enc.encode_waveforms(clips[i:i + 8], materialize=False)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0

    outs = _recording(dec)
    _zero_steps(dec)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    out = pipe.predict(clips, target_lang="eng_Latn", batch_size=8, **DECODE_KW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_launches()
    del dec.materialize_beam
    steps, ran = dec.decode_steps, dec.device_steps
    n_tok = int(sum(o[2][:, 0].sum() for o in outs))
    log(f"speech->text bf16 (2 batches in flight): {len(clips)} clips ({audio_s:.1f} s of "
        f"audio) in {dt:.3f} s = {len(clips) / dt:.2f} clips/s = {len(out) / dt:.2f} "
        f"sentences/s, RTFx {audio_s / dt:.1f}, {n_tok} generated tokens; encoder alone "
        f"{encode_s:.3f} s; {_steps_line(dec)}; (wall - encoder) / steps "
        f"{(dt - encode_s) * 1e3 / steps:.3f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {card}")
    log(f"speech->text bf16: launches {counts}")
    if not (counts["relpos_flash_attention_v2"] > 0
            and counts["beam_masked_attend"] == n_layers * ran > 0):
        raise AssertionError(f"speech->text: v2 launched {counts['relpos_flash_attention_v2']} "
                             f"times, beam_masked_attend {counts['beam_masked_attend']} over "
                             f"the card's {ran} steps of {n_layers} layers")
    if len(out) != len(clips) or not all(isinstance(t, str) for t in out):
        raise AssertionError(f"speech->text: {len(out)} outputs for {len(clips)} clips")

    # The window of two against batch by batch (each batch's audio, encode
    # and decode done before the next batch starts), on the 16 clips twice
    # over (4 batches of 8), in turns.
    more = clips + clips
    converter = EmbeddingToTextConverter(dec, tok, "eng_Latn", BeamSearchConfig(**DECODE_KW))

    def batch_by_batch():
        return [t for i in range(0, len(more), 8) for t in converter.batch_convert(
            enc.encode_waveforms([pipe._decode_audio(c) for c in more[i:i + 8]],
                                 materialize=False))]

    runs, results = {}, {}
    for label in ("window 2", "batch by batch", "batch by batch", "window 2"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[label] = (pipe.predict(more, target_lang="eng_Latn", batch_size=8, **DECODE_KW)
                          if label == "window 2" else batch_by_batch())
        torch.cuda.synchronize()
        runs.setdefault(label, []).append(round(len(more) / (time.perf_counter() - t0), 2))
    same = results["window 2"] == results["batch by batch"]
    log(f"speech->text bf16, {len(more)} clips in batches of 8: predict (window 2) equal to batch "
        f"by batch {same} {'ok' if same else 'FAIL'}; clips/s by run {runs}; on {card}")
    if not same:
        raise AssertionError("speech->text: the window of two differs from batch by batch")
    del pipe, enc
    torch.cuda.empty_cache()

    # The card against the CPU port in fp32 on 2 short clips (S 149 and 249:
    # the v2 kernel on the card, its plain version on the CPU): the
    # embeddings as in (e), then the beam search of the card's embeddings on
    # both sides (the same memory), whose best hypotheses must agree.
    ref = [_clip(rng, x) for x in (3.0, 5.0)]
    prefix = tok.create_encoder(lang="eng_Latn", mode="target").prefix_indices
    gen_cfg = BeamSearchConfig(**DECODE_KW)
    t0 = time.perf_counter()
    on_card = TorchSpeechEncoder(speech_encoder_from_numpy(
        handoff["speech_params"], cfg, torch.float32, DEVICE)).encode_waveforms(ref)
    on_cpu = TorchSpeechEncoder(speech_encoder_from_numpy(
        handoff["speech_params"], cfg, torch.float32, "cpu"), device="cpu").encode_waveforms(ref)
    max_abs, scale = float(np.abs(on_card - on_cpu).max()), float(np.abs(on_cpu).max())
    cpu_dec = TorchTextDecoder(text_decoder_from_numpy(handoff["decoder_params"], dcfg,
                                                       torch.float32, "cpu"), device="cpu")
    card_beam = handoff["decoders"]["fp32"].generate_beam(on_card[:, None, :], prefix, gen_cfg)
    _same_best("speech->text fp32", card_beam,
               cpu_dec.generate_beam(on_card[:, None, :], prefix, gen_cfg))
    ok = max_abs <= 1e-3 * scale
    log(f"speech->text fp32 card vs CPU on 2 clips: embeddings max_abs {max_abs:.3e} (<= 1e-3 x "
        f"scale {scale:.3g}), best hypotheses agree {'ok' if ok else 'FAIL'} "
        f"(CPU {time.perf_counter() - t0:.1f} s)")
    if not ok:
        raise AssertionError("speech->text fp32: the card's embeddings disagree with the CPU's")
    return counts


# -- (h) sampling, int8 decode and the heads ---------------------------------------------------


class _RecordingSampler:
    """A sampler that keeps each step's filtered log-probabilities (on the
    host), to tell a tie from a fault where two sampled tokens differ."""

    def __init__(self, sampler):
        self.sampler = sampler
        self.temperature = getattr(sampler, "temperature", 1.0)
        self.filtered = []

    def filter_logprobs(self, lp):
        out = self.sampler.filter_logprobs(lp)
        self.filtered.append(out.float().cpu())
        return out


def run_sampling_int8_heads(torch, card, handoff):
    import numpy as np

    from sonar_tpu_torch.assets import convert
    from sonar_tpu_torch.generation.beam_search import BeamSearchConfig
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.generation.sampling import TopKSampler, TopPSampler
    from sonar_tpu_torch.inference_pipelines.mutox_speech import MutoxSpeechClassifierPipeline
    from sonar_tpu_torch.inference_pipelines.speech import TorchSpeechEncoder
    from sonar_tpu_torch.inference_pipelines.text import EmbeddingToTextModelPipeline
    from sonar_tpu_torch.models import blaser, laser2_text, mutox
    from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs
    from sonar_tpu_torch.tokenizers.laser2 import Laser2Tokenizer

    tok, emb, decoders = handoff["tokenizer"], handoff["embeddings"], handoff["decoders"]
    dcfg = sonar_text_decoder_archs.get("basic")
    n_layers, vocab = dcfg.num_decoder_layers, dcfg.vocab_info.size
    launches = dict.fromkeys(KERNELS, 0)

    def drive(label, dec, fn, n_items, beam=False):
        _zero_steps(dec)
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_launches()
        for name in KERNELS:
            launches[name] += counts[name]
        steps, ran = dec.decode_steps, dec.device_steps
        log(f"{label}: {n_items} sentences in {dt:.3f} s = {n_items / dt:.2f} sentences/s, "
            f"{_steps_line(dec)}, {dt * 1e3 / steps:.3f} ms per decode step; launches "
            f"{ {k: v for k, v in counts.items() if v} }; on {card}")
        if beam and counts["beam_masked_attend"] != n_layers * ran:
            raise AssertionError(f"{label}: beam_masked_attend launched "
                                 f"{counts['beam_masked_attend']} times over the card's {ran} "
                                 f"steps")
        if len(out) != n_items or not all(isinstance(t, str) for t in out):
            raise AssertionError(f"{label}: {len(out)} outputs for {n_items} inputs")
        return out

    # Sampling at full width, bf16 and fp32, through the pipeline; the
    # device busy share of one top-p batch of 32 in each, over 16 steps
    # (the profiler's read of a longer run costs tens of seconds).
    for mode in ("bf16", "fp32"):
        pipe = EmbeddingToTextModelPipeline(decoders[mode], tok)
        for name, sampler in (("top-p 0.9", TopPSampler(0.9)), ("top-k 10", TopKSampler(10))):
            drive(f"sampling {mode} {name} (64 embeddings, batch 32, max_gen_len 48)",
                  decoders[mode], lambda: pipe.predict(emb, target_lang="eng_Latn", batch_size=32,
                                                       sampler=sampler, max_gen_len=48), len(emb))
        _busy_share(torch, card, f"sampling {mode} top-p batch of 32, max_gen_len 16",
                    decoders[mode],
                    lambda: pipe.predict(emb[:32], target_lang="eng_Latn", batch_size=32,
                                         sampler=TopPSampler(0.9), max_gen_len=16), top=5)

    # Sampling, the card against the CPU port in fp32 on 4 embeddings, with
    # the same Gumbel noise drawn once on the host.
    prefix = tok.create_encoder(lang="eng_Latn", mode="target").prefix_indices
    gen = torch.Generator().manual_seed(0)
    draws = [-torch.log(-torch.log(torch.rand(4, vocab, generator=gen).clamp_min(1e-38)))
             for _ in range(48)]
    memory = emb[:4, None, :]
    t0 = time.perf_counter()
    cpu_dec = TorchTextDecoder(convert.text_decoder_from_numpy(
        handoff["decoder_params"], dcfg, torch.float32, "cpu"), device="cpu")
    rec = _RecordingSampler(TopPSampler(0.9))
    ct, cs, cl = decoders["fp32"].generate_sample(memory, prefix, TopPSampler(0.9), 48,
                                                  noise=lambda step, shape: draws[step])
    pt, ps, pl = cpu_dec.generate_sample(memory, prefix, rec, 48,
                                         noise=lambda step, shape: draws[step])
    for r in range(4):
        diff = [i for i in range(ct.shape[1]) if ct[r, i] != pt[r, i]]
        if not diff:
            continue
        scores = (rec.filtered[diff[0]][r] + draws[diff[0]][r]).double()
        top2 = torch.topk(scores, 2).values
        tie = float(top2[0] - top2[1]) <= 1e-5
        log(f"sampling fp32 row {r}: tokens differ from step {diff[0]} (the CPU's two best "
            f"noisy scores {float(top2[0]):.7f}, {float(top2[1]):.7f}); "
            f"{'a tie within 1e-5: not a failure' if tie else 'FAIL'}")
        if not tie:
            raise AssertionError(f"sampling fp32: the card's tokens of row {r} are not the CPU's")
    log(f"sampling fp32 card vs CPU on 4 embeddings (top-p 0.9, the same noise): tokens agree, "
        f"lengths {cl.tolist()}, max score gap {float(np.abs(cs - ps).max()):.3e} "
        f"(CPU {time.perf_counter() - t0:.1f} s)")

    # int8 decode: every projection int8, the tied projection in floating
    # point. The speed run in bf16 activations (beam 5, the 64 embeddings,
    # and 2 embeddings, whose 10 beam rows take int8_matmul's float64 route
    # below 17 rows, beside bf16 at the same batch); the checks in fp32.
    q_bf16 = TorchTextDecoder(decoders["bf16"].model, quantize=True)
    q_pipe = EmbeddingToTextModelPipeline(q_bf16, tok)
    q_pipe.predict(emb[:32], target_lang="eng_Latn", batch_size=32, **DECODE_KW)  # warm
    drive("int8 decode bf16 (64 embeddings, batch 32, beam 5, max_gen_len 48)", q_bf16,
          lambda: q_pipe.predict(emb, target_lang="eng_Latn", batch_size=32, **DECODE_KW),
          len(emb), beam=True)
    _busy_share(torch, card, "int8 decode bf16 batch of 32, max_gen_len 16", q_bf16,
                lambda: q_pipe.predict(emb[:32], target_lang="eng_Latn", batch_size=32,
                                       beam_size=5, max_gen_len=16), top=5)
    for label, dec in (("int8 decode bf16", q_bf16), ("bf16 decode", decoders["bf16"])):
        drive(f"{label} (2 embeddings, 10 beam rows, max_gen_len 48)", dec,
              lambda: EmbeddingToTextModelPipeline(dec, tok).predict(
                  emb[:2], target_lang="eng_Latn", batch_size=2, **DECODE_KW), 2, beam=True)
    del q_pipe, q_bf16
    q32 = TorchTextDecoder(decoders["fp32"].model, quantize=True)
    q32_cpu = TorchTextDecoder(cpu_dec.model, quantize=True, device="cpu")
    beam = q32.generate_beam(memory, prefix, BeamSearchConfig(**DECODE_KW))
    lens = len(prefix) + beam[2][:, 0]
    seqs = np.full((4, int(lens.max())), 1, np.int32)
    for r in range(4):
        seqs[r, :lens[r]] = list(prefix) + beam[0][r, 0, : beam[2][r, 0]].tolist()
    valid = np.arange(seqs.shape[1])[None, :] < lens[:, None]
    t0 = time.perf_counter()
    got = q32.score(seqs, lens, memory)[valid]
    vs_fp32 = _cos_rows(got, decoders["fp32"].score(seqs, lens, memory)[valid]).min()
    vs_cpu = _cos_rows(got, q32_cpu.score(seqs, lens, memory)[valid]).min()
    ok = vs_fp32 >= 0.99 and vs_cpu >= 0.9999
    log(f"int8 decode fp32 teacher-forced logits on 4 embeddings: min row cos {vs_fp32:.6f} "
        f"against the card's fp32 decoder (>= 0.99), {vs_cpu:.6f} against the CPU port in int8 "
        f"(>= 0.9999) {'ok' if ok else 'FAIL'} (CPU {time.perf_counter() - t0:.1f} s)")
    if not ok:
        raise AssertionError("int8 decode: the logits disagree")
    del q32, q32_cpu, cpu_dec
    torch.cuda.empty_cache()

    def head(label, card_fn, cpu_fn, n_items, rows=None):
        """Time ``card_fn`` (items/s), then hold its output's ``rows`` (by
        default the first ones) against ``cpu_fn``'s: max-abs <= 1e-4 of
        the output's scale."""
        card_fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = card_fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = out.float().cpu().numpy()
        want = cpu_fn().float().numpy()
        got = got[: want.shape[0]] if rows is None else got[rows]
        max_abs, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        ok = np.isfinite(got).all() and max_abs <= 1e-4 * scale
        log(f"{label}: {n_items} items in {dt * 1e3:.3f} ms = {n_items / dt:.1f} items/s, output "
            f"{tuple(out.shape)}; card vs CPU fp32 on {want.shape[0]} rows max_abs {max_abs:.3e} "
            f"(<= 1e-4 x scale {scale:.3g}) {'ok' if ok else 'FAIL'}; on {card}")
        if not ok:
            raise AssertionError(f"{label}: the card disagrees with the CPU reference")

    # BLASER and MuTox on the corpus embeddings of (d) (src, mt and ref are
    # the embeddings rolled by 0, 1 and 2 rows).
    corpus_emb = handoff["corpus_embeddings"]
    n = len(corpus_emb)
    src, mt, ref = (np.roll(corpus_emb, k, axis=0) for k in range(3))
    src_d, mt_d, ref_d = (torch.tensor(a, device=DEVICE) for a in (src, mt, ref))
    for arch in ("basic_ref", "basic_qe"):
        cfg = blaser.blaser_archs.get(arch)
        params = convert.init_blaser_params(cfg, seed=0)
        on_card = convert.blaser_from_numpy(params, cfg, DEVICE)
        on_cpu = convert.blaser_from_numpy(params, cfg, "cpu")
        head(f"BLASER {arch} ({n} embeddings)", lambda: on_card(src_d, mt_d, ref_d),
             lambda: on_cpu(src[:512], mt[:512], ref[:512]), n)
    mcfg = mutox.mutox_archs.get("mutox")
    mparams = convert.init_mutox_params(mcfg, seed=0)
    classifier = convert.mutox_from_numpy(mparams, mcfg, DEVICE)
    head(f"MuTox ({n} embeddings)", lambda: classifier(src_d),
         lambda: convert.mutox_from_numpy(mparams, mcfg, "cpu")(src[:512]), n)
    speech_enc = TorchSpeechEncoder(convert.speech_encoder_from_numpy(
        handoff["speech_params"], sonar_speech_encoder_archs.get("english"), torch.bfloat16,
        DEVICE))
    rng = np.random.default_rng(2)
    clips = [_clip(rng, x) for x in rng.uniform(2.0, 10.0, 8)]
    mpipe = MutoxSpeechClassifierPipeline(classifier, speech_enc)
    mpipe.predict(clips[:2], batch_size=8)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    probs = mpipe.predict(clips, batch_size=8, output_prob=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_launches()
    for name in KERNELS:
        launches[name] += counts[name]
    log(f"MuTox speech pipeline bf16 encoder: 8 clips in {dt:.3f} s = {8 / dt:.2f} clips/s, "
        f"probabilities {np.round(probs[:, 0], 4).tolist()}; launches "
        f"{ {k: v for k, v in counts.items() if v} }; on {card}")
    if probs.shape != (8, 1) or not ((probs >= 0) & (probs <= 1)).all():
        raise AssertionError(f"MuTox speech pipeline: scores of shape {probs.shape}")
    del mpipe, speech_enc, src_d, mt_d, ref_d
    torch.cuda.empty_cache()

    # LASER2 at the published width on 512 sentences of (d)'s corpus,
    # tokenized by a Laser2Tokenizer over (d)'s synthetic SentencePiece model.
    lcfg = laser2_text.laser2_archs.get("laser2")
    t0 = time.perf_counter()
    lparams = convert.init_laser2_params(lcfg, seed=0)
    laser = convert.laser2_from_numpy(lparams, lcfg, device=DEVICE)
    encode = Laser2Tokenizer(handoff["tokenizer_path"]).create_encoder()
    ids = sorted((encode(t) for t in handoff["corpus"][:512]), key=len)
    batches = []
    for i in range(0, len(ids), 128):
        chunk = ids[i:i + 128]
        seqs = np.full((len(chunk), max(map(len, chunk))), lcfg.pad_idx, np.int64)
        for r, x in enumerate(chunk):
            seqs[r, : len(x)] = x
        batches.append((torch.tensor(seqs, device=DEVICE),
                        torch.tensor([len(x) for x in chunk], device=DEVICE)))
    log(f"LASER2 weights drawn and 512 sentences tokenized in {time.perf_counter() - t0:.1f} s "
        f"(vocab {lcfg.vocabulary_size}, embed {lcfg.model_dim}, {lcfg.num_layers} x BiLSTM "
        f"{lcfg.hidden_size}; lengths {len(ids[0])}-{len(ids[-1])})")
    # The CPU reference runs the 4 shortest and the 4 longest rows of every
    # batch (the ids are sorted by length): every length range of the corpus,
    # each row computed on the card beside rows of very different lengths.
    cpu_laser = convert.laser2_from_numpy(lparams, lcfg, device="cpu")
    picks = [sorted({*range(4), *range(len(l_) - 4, len(l_))}) for _, l_ in batches]
    rows = [128 * b + r for b, pick in enumerate(picks) for r in pick]
    head("LASER2 laser2 (512 sentences, batches of 128; checked: the 4 shortest and 4 longest "
         "of each batch)",
         lambda: torch.cat([laser(s_, l_) for s_, l_ in batches]),
         lambda: torch.cat([cpu_laser(s_[pick].cpu(), l_[pick].cpu())
                            for (s_, l_), pick in zip(batches, picks)]), len(ids), rows)
    return launches


# -- (h2) the captured sampling program against the eager body -----------------------------


SAMPLE_GEN_LEN = 48  # (h2)'s max_gen_len, as (h)'s
SAMPLE_NEW_KEY_GEN_LEN = 45  # (h2): a limit no sampling call used before: its first call captures
FRESH_MIN_DISTINCT = 40  # (h2): distinct tokens of 48 uniform draws of 256,206 (about 48 expected)


class _FlatSampler:
    """A sampler whose filter keeps every column at 0 but EOS (-1e30, so that
    no row stops): each token is a uniform draw of the vocabulary, which a
    draw fixed at capture would repeat at every step of the loop."""

    temperature = 1.0

    def __init__(self, eos):
        self.eos = eos

    def filter_logprobs(self, lp):
        out = lp.new_zeros(lp.shape)
        out[:, self.eos] = -1e30
        return out


def _sample_ties(label, card_out, cpu_out, filtered, noise_of, tol=1e-5):
    """The card's and the CPU's sampled tokens agree, or, where a row's
    tokens differ, its two best noisy scores at the first differing step
    (the CPU's filtered rows plus ``noise_of(step)``) lie within ``tol``
    (printed, not failed)."""
    import torch

    (ct, _, _), (pt, _, _) = card_out, cpu_out
    for r in range(ct.shape[0]):
        diff = [i for i in range(ct.shape[1]) if ct[r, i] != pt[r, i]]
        if not diff:
            continue
        scores = (filtered[diff[0]][r] + noise_of(diff[0])[r]).double()
        top2 = torch.topk(scores, 2).values
        tie = float(top2[0] - top2[1]) <= tol
        log(f"{label} row {r}: tokens differ from step {diff[0]} (the CPU's two best noisy "
            f"scores {float(top2[0]):.7f}, {float(top2[1]):.7f}); "
            f"{'a tie within 1e-5: not a failure' if tie else 'FAIL'}")
        if not tie:
            raise AssertionError(f"{label}: the card's tokens of row {r} are not the CPU's")


def run_sample_graph(torch, card, handoff):
    """(h2): sampling through the captured CUDA graphs and the loop on the
    card (``generate_sample``) against the same loop run eagerly on the card
    (``_sample_eager``: the same body, setup and tail, the same padded batch
    and seeds), on (f)'s 64 embeddings in batches of 32, top-p 0.9 and
    top-k 10, max_gen_len 48, in bf16, fp32 and int8 (``quantize=True``):
    tokens, scores and lengths bit for bit; each path's ms a decode step
    and the steps the card ran; ``gumbel_max`` launched once a body step
    the card ran. Then, in bf16: a seed repeats its samples and another
    gives others; the first call of a new key (max_gen_len 45: its capture)
    timed against the next, with the memory it holds (on a runtime of its
    own); the busy share over one top-p batch of 32 (the graph path over 48
    steps, the eager body over 16); the fresh-noise check (48 steps of a flat
    filter, each row's tokens >= 40 distinct values of 256,206). Last, fp32
    top-p on 4 embeddings from one seed against the CPU port (the plain
    draw), tokens equal but in a tie within 1e-5."""
    import numpy as np

    from sonar_tpu_torch.assets import convert
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.generation.sampling import TopKSampler, TopPSampler
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs
    from sonar_tpu_torch.ops.cuda import gumbel_max as gm

    tok, emb, decoders = handoff["tokenizer"], handoff["embeddings"], handoff["decoders"]
    prefix = list(tok.create_encoder(lang="eng_Latn", mode="target").prefix_indices)
    dcfg = sonar_text_decoder_archs.get("basic")
    batches = [emb[i:i + 32, None, :] for i in range(0, len(emb), 32)]
    launches = dict.fromkeys(KERNELS, 0)

    def counted(fn):
        zero_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = read_launches()
        for name in KERNELS:
            launches[name] += counts[name]
        return out, counts

    def graph_run(dec, sampler, gen_len=SAMPLE_GEN_LEN, seed0=0):
        return [dec.generate_sample(m, prefix, sampler, gen_len, seed=seed0 + i)
                for i, m in enumerate(batches)]

    def eager_run(dec, sampler):
        return [dec._sample_eager(torch.as_tensor(m, device=DEVICE), prefix, sampler,
                                  SAMPLE_GEN_LEN, seed=i) for i, m in enumerate(batches)]

    int8 = TorchTextDecoder(decoders["bf16"].model, quantize=True)
    for mode, dec in (("bf16", decoders["bf16"]), ("fp32", decoders["fp32"]), ("int8", int8)):
        for label, sampler in (("top-p 0.9", TopPSampler(0.9)), ("top-k 10", TopKSampler(10))):
            dec.generate_sample(batches[0], prefix, sampler, SAMPLE_GEN_LEN)  # warm: the capture
            outs = {}
            for path, run in (("graph", graph_run), ("eager", eager_run)):
                _zero_steps(dec)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[path], counts = counted(lambda: run(dec, sampler))
                dt = time.perf_counter() - t0
                body = dec.device_steps - len(prefix) * len(batches)
                log(f"(h2) {mode} {label} {path}: {len(emb)} sentences in {dt:.3f} s = "
                    f"{len(emb) / dt:.2f} sentences/s, {dt * 1e3 / dec.decode_steps:.3f} ms per "
                    f"decode step; {_steps_line(dec)}; gumbel_max {counts['gumbel_max']} "
                    f"launches for the {body} body steps the card ran; on {card}")
                if counts["gumbel_max"] != body:
                    raise AssertionError(f"(h2) {mode} {label} {path}: gumbel_max launched "
                                         f"{counts['gumbel_max']} times over {body} body steps")
            pairs = list(zip(outs["graph"], outs["eager"]))
            same = all(np.array_equal(g, e) for go, eo in pairs for g, e in zip(go, eo))
            rows = sum(int((g[0] != e[0]).any(axis=1).sum()) for g, e in pairs)
            gap = max(float(np.abs(g[1] - e[1]).max()) for g, e in pairs)
            lens = [int(x) for o in outs["graph"] for x in o[2]]
            log(f"(h2) {mode} {label} graph vs eager body on {len(emb)} embeddings: tokens, "
                f"scores and lengths {'bit for bit' if same else 'DIFFER'} ({rows} rows' tokens "
                f"differ, score gap {gap:.3e}; lengths {min(lens)}-{max(lens)}) "
                f"{'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"(h2) {mode} {label}: the captured program disagrees with "
                                     f"the eager body")
            if mode == "bf16" and label == "top-p 0.9":
                again, other = graph_run(dec, sampler), graph_run(dec, sampler, seed0=100)
                repeat = all(np.array_equal(a, g) for ao, go in zip(again, outs["graph"])
                             for a, g in zip(ao, go))
                differ = all(not np.array_equal(o[0], g[0])
                             for o, g in zip(other, outs["graph"]))
                log(f"(h2) bf16 top-p: the same seeds again equal bit for bit {repeat}, other "
                    f"seeds give other tokens in every batch {differ} "
                    f"{'ok' if repeat and differ else 'FAIL'}")
                if not (repeat and differ):
                    raise AssertionError("(h2): the seed does not decide the samples")
    del int8
    torch.cuda.empty_cache()

    # The cost of a capture: the first call of a new key against the next,
    # on a runtime of its own over the bf16 model (no other graph to evict,
    # its own pool).
    dec, sampler = TorchTextDecoder(decoders["bf16"].model), TopPSampler(0.9)
    ms, got = [], []
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    for _ in range(2):
        _zero_steps(dec)
        t0 = time.perf_counter()
        got.append(dec.generate_sample(batches[0], prefix, sampler, SAMPLE_NEW_KEY_GEN_LEN))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if len(ms) == 1:
            held = (torch.cuda.memory_allocated() - held[0],
                    torch.cuda.memory_reserved() - held[1])
    eager = dec._sample_eager(torch.as_tensor(batches[0], device=DEVICE), prefix, sampler,
                              SAMPLE_NEW_KEY_GEN_LEN)
    same = all(np.array_equal(g, e) for out in got for g, e in zip(out, eager))
    log(f"(h2) bf16 top-p max_gen_len {SAMPLE_NEW_KEY_GEN_LEN}, batch of 32 (a new key): first "
        f"call {ms[0]:.1f} ms (an eager setup and step, the setup and the step captured, the "
        f"loop instantiated; then the decode), the next {ms[1]:.1f} ms ({_steps_line(dec)}): "
        f"the capture costs {ms[0] - ms[1]:.1f} ms; the new graph holds "
        f"{held[0] / 2**30:.3f} GiB allocated, {held[1] / 2**30:.3f} GiB more reserved; both "
        f"calls equal to the eager body bit for bit {same} {'ok' if same else 'FAIL'}; on {card}")
    if not same:
        raise AssertionError("(h2): a new key's captured program disagrees with the eager body")
    del dec
    torch.cuda.empty_cache()

    # Busy shares over one top-p batch of 32: the graph path over 48 steps,
    # the eager body over 16 (the profiler's read of its ~1,600 launches a
    # step costs about a second a step).
    dec, mem = decoders["bf16"], batches[0]
    for path, n, fn in (
            ("graph", SAMPLE_GEN_LEN,
             lambda: dec.generate_sample(mem, prefix, sampler, SAMPLE_GEN_LEN)),
            ("eager body", 16, lambda: dec._sample_eager(torch.as_tensor(mem, device=DEVICE),
                                                         prefix, sampler, 16))):
        _busy_share(torch, card, f"(h2) sampling bf16 top-p batch of 32, max_gen_len {n}, {path}",
                    dec, fn, top=5)

    # Fresh noise at every turn of the loop on the card: a flat filter makes
    # each token a uniform draw of the vocabulary.
    flat = dec.generate_sample(np.zeros((32, 1, dcfg.model_dim), np.float32), prefix,
                               _FlatSampler(dcfg.vocab_info.eos_idx), SAMPLE_GEN_LEN, seed=3)
    distinct = [len(set(row[:SAMPLE_GEN_LEN].tolist())) for row in flat[0]]
    ok = min(distinct) >= FRESH_MIN_DISTINCT and (flat[2] == SAMPLE_GEN_LEN + 1).all()
    log(f"(h2) fresh noise: 32 rows x {SAMPLE_GEN_LEN} steps of a flat filter in the captured "
        f"loop: distinct tokens a row {min(distinct)}-{max(distinct)} (>= {FRESH_MIN_DISTINCT}; "
        f"a draw fixed at capture gives 1) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(h2): the captured loop does not draw fresh noise each step")

    # The card against the CPU port, fp32 top-p from one seed on 4 embeddings.
    memory = emb[:4, None, :]
    t0 = time.perf_counter()
    cpu_dec = TorchTextDecoder(convert.text_decoder_from_numpy(
        handoff["decoder_params"], dcfg, torch.float32, "cpu"), device="cpu")
    rec = _RecordingSampler(TopPSampler(0.9))
    card_out = decoders["fp32"].generate_sample(memory, prefix, TopPSampler(0.9), SAMPLE_GEN_LEN,
                                                seed=7)
    cpu_out = cpu_dec.generate_sample(memory, prefix, rec, SAMPLE_GEN_LEN, seed=7)
    key = gm.prng_key(7)
    _sample_ties("(h2) sampling fp32 from a seed", card_out, cpu_out, rec.filtered,
                 lambda step: gm.threefry_gumbel(key, step, 0, 4, dcfg.vocab_info.size))
    log(f"(h2) sampling fp32 card vs CPU on 4 embeddings (top-p 0.9, seed 7, no hook): tokens "
        f"agree, lengths {card_out[2].tolist()}, max score gap "
        f"{float(np.abs(card_out[1] - cpu_out[1]).max()):.3e} (CPU {time.perf_counter() - t0:.1f} "
        f"s)")
    del cpu_dec
    return launches


# -- (i) mining ------------------------------------------------------------------------

MINING_ROWS, MINING_DIM, MINING_K = 65536, 1024, 8  # scripts/bench_mining.py:26's size
MINING_SAMPLE = 512  # query rows held against the CPU
FLORES_ROWS, FLORES_DISTRACTORS = 1012, 10000  # FLORES devtest; xsim++'s distractors


def _planted(torch, gen, n, d, noise):
    """x: n random unit rows; y: x plus Gaussian noise of ``noise`` times a
    unit row's norm, normalised, so that y[i] is x[i]'s true partner
    (cosine ~ 1 / sqrt(1 + noise^2))."""
    x = torch.randn(n, d, generator=gen, device=DEVICE)
    x = x / x.norm(dim=1, keepdim=True)
    y = x + noise * torch.randn(n, d, generator=gen, device=DEVICE) / d ** 0.5
    return x, y / y.norm(dim=1, keepdim=True)


def run_mining(torch, card):
    """Phase (i): ``cosine_topk`` at 65,536 x 65,536, D 1024, k 8 in fp32,
    bf16 and int8, exact and approx; 512 query rows against the CPU;
    ``mine_bitexts`` (intersection, ratio); ``xsim`` / ``xsim_pp`` at
    FLORES devtest size against the CPU. Returns the launch counts of the
    driven run (mining calls no kernel of the port)."""
    from sonar_tpu_torch.parallel import mining

    n, d, k = MINING_ROWS, MINING_DIM, MINING_K
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x, y = _planted(torch, gen, n, d, 2.0)
    modes = {"fp32": None, "bf16": torch.bfloat16, "int8": "int8"}
    torch.cuda.synchronize()
    out, failures = {}, []
    zero_launches()
    for mode, dot in modes.items():
        for approx in (False, True):
            fn = lambda: mining.cosine_topk(x, y, k, dot_dtype=dot, approx=approx)  # noqa: E731
            fn()
            runs = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn()
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
            out[mode, approx] = res
            log(f"mining cosine_topk {mode} {'approx' if approx else 'exact'} [{n}, {d}] x "
                f"[{n}, {d}] top {k}: {runs[0] * 1e3:.1f} / {runs[1] * 1e3:.1f} ms = "
                f"{n / min(runs):.0f} query rows/s; on {card}")
        ops, wall, _ = _device_profile(torch, lambda: mining.cosine_topk(x, y, k, dot_dtype=dot))
        busy = sum(ms for ms, _ in ops.values())
        log(f"mining cosine_topk {mode}: device busy {busy:.1f} ms of {wall:.1f} ms wall under the "
            f"profiler; " + ("; ".join(f"{name[:60]} {ms:.1f} ms x{n}" for name, (ms, n) in sorted(
                ops.items(), key=lambda kv: -kv[1][0])[:6]) if ops else "no device time seen"))
        same = all(torch.equal(a, b) for a, b in zip(out[mode, False], out[mode, True]))
        log(f"check mining {mode}: approx equals exact bit for bit (the exact selector) "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            failures.append(f"mining {mode} approx")
    t0 = time.perf_counter()
    src, tgt, score = mining.mine_bitexts(x, y, k=4, margin="ratio", strategy="intersection")
    dt = time.perf_counter() - t0
    launches = read_launches()
    precision = float((src == tgt).mean()) if len(src) else 0.0
    log(f"mining mine_bitexts intersection ratio (fp32, k 4): {len(src)} pairs of {n} planted "
        f"in {dt:.2f} s, planted-pair precision {precision:.4f}, scores "
        f"{float(score.min()):.4f}-{float(score.max()):.4f}")
    if not (len(src) >= 0.9 * n and precision >= 0.99):
        failures.append("mine_bitexts")

    # Recall of the planted partner at 1 and of the card's fp32 top k.
    ref_i = out["fp32", False][1]
    truth = torch.arange(n, device=DEVICE)
    for mode in modes:
        got_i = out[mode, False][1]
        at1 = (got_i[:, 0] == truth).float().mean().item()
        recall = (got_i[:, :, None] == ref_i[:, None, :]).any(dim=2).float().mean().item()
        log(f"mining {mode}: planted partner first in {at1:.5f} of rows; recall@{k} against "
            f"the card's fp32 {recall:.5f}")
        if at1 < 0.99 or recall < (1.0 if mode == "fp32" else 0.9):
            failures.append(f"mining {mode} recall")

    # MINING_SAMPLE query rows against the whole bank on the CPU: fp32 indices
    # equal but in rows with a (near) tie among the CPU's top k + 1 (1e-6),
    # scores within 1e-5; int8 equal bit for bit (the codes and the int32 sums
    # are the same on both); bf16 scores within 1e-2 and recall >= 0.99.
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(1))[:MINING_SAMPLE]
    xs, yc = x[rows.to(DEVICE)].cpu(), y.cpu()
    for mode, dot in modes.items():
        t0 = time.perf_counter()
        cs, ci = mining.cosine_topk(xs, yc, k + 1, dot_dtype=dot, device="cpu")
        gs, gi = (t[rows.to(DEVICE)].cpu() for t in out[mode, False])
        gaps = -cs.diff(dim=1)
        cs, ci = cs[:, :k], ci[:, :k]
        err = (gs - cs).abs().max().item()
        if mode == "int8":
            ok = torch.equal(gs, cs) and torch.equal(gi, ci)
            what = "scores and indices equal bit for bit"
        elif mode == "fp32":
            near = (gaps <= 1e-6).any(dim=1)
            ok = err <= 1e-5 and torch.equal(gi[~near], ci[~near])
            what = f"indices equal in the {int((~near).sum())} rows without a tie within 1e-6"
        else:
            recall = (gi[:, :, None] == ci[:, None, :]).any(dim=2).float().mean().item()
            ok = err <= 1e-2 and recall >= 0.99
            what = f"recall@{k} {recall:.4f} (>= 0.99)"
        log(f"check mining {mode} card vs CPU on {MINING_SAMPLE} query rows: max score error "
            f"{err:.3e}, {what} (CPU {time.perf_counter() - t0:.1f} s) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"mining {mode} card vs CPU")
    del out, x, y, xs, yc
    torch.cuda.empty_cache()

    # xsim / xsim++ at FLORES devtest size, noisy enough that some rows
    # misalign; the card's error rates against the CPU's.
    fx, fy = _planted(torch, gen, FLORES_ROWS, d, 6.0)
    distractors, _ = _planted(torch, gen, FLORES_DISTRACTORS, d, 0.0)
    for margin in ("ratio", "distance", "absolute"):
        card_err = (mining.xsim(fx, fy, margin=margin),
                    mining.xsim_pp(fx, fy, distractors, margin=margin))
        cpu_err = (mining.xsim(fx.cpu(), fy.cpu(), margin=margin, device="cpu"),
                   mining.xsim_pp(fx.cpu(), fy.cpu(), distractors.cpu(), margin=margin,
                                  device="cpu"))
        ok = card_err == cpu_err
        log(f"check mining xsim / xsim++ {margin} ({FLORES_ROWS} rows, {FLORES_DISTRACTORS} "
            f"distractors): card {card_err[0]:.4f} / {card_err[1]:.4f} %, CPU {cpu_err[0]:.4f} / "
            f"{cpu_err[1]:.4f} % {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"xsim {margin}")
    if failures:
        raise AssertionError(f"mining checks failed: {failures}")
    return launches


# -- (j) serving, the precision scope under load, packed encoding, the HF layer ----------


SERVE_THREADS, SERVE_REQUESTS = 8, 16  # /embed burst: threads x requests of 1-32 sentences
SPEECH_THREADS, SPEECH_REQUESTS = 2, 4  # /embed_speech burst: requests of 2 clips of 3-20 s
PACK_ROW_LEN, PACK_ROWS, PACK_SEGMENTS = 128, 64, 16  # scripts/bench_r2_sweep.py:42,77
PACK_CPU_ROWS = 16  # packed rows held against the CPU: 2048 tokens, the int8 FFN's gate
FP32_SERVE_LIMIT = 1e-4  # (j2): served fp32 replies against direct predict, x the scale


def _fire(jobs):
    """Run each ``(name, fn)`` of ``jobs`` in a thread of its own; returns
    {name: result} and the wall seconds. A job's exception is raised here."""
    import threading

    results, errors = {}, []

    def run(name, fn):
        try:
            results[name] = fn()
        except BaseException as err:  # reported on the main thread
            errors.append((name, err))

    threads = [threading.Thread(target=run, args=job, daemon=True) for job in jobs]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    dt = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("a client thread did not finish within 600 s")
    if errors:
        raise AssertionError(f"client threads failed: {errors[:3]}") from errors[0][1]
    return results, dt


def _flags(torch):
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


def _counted(torch, launches, fn):
    """``fn()`` with every launch count set to 0 just before it and read just
    after it: the counts of the served calls alone, never of the direct
    reference calls that check them. Adds them into ``launches`` and returns
    ``fn``'s result and the counts."""
    torch.cuda.synchronize()
    zero_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = read_launches()
    for name in KERNELS:
        launches[name] += counts[name]
    return out, counts


def _tf32_control(torch, fn):
    """``fn()`` as it would run if the fp32 scope did not hold: the scope
    made a no-op and TF32 on in cuBLAS and cuDNN. The reading of a fault
    that (j2)'s limit must catch; the flags are restored after."""
    from sonar_tpu_torch.ops import precision

    class _Open:
        def enter(self):
            pass

        def exit(self):
            pass

    saved, flags = precision._FP32, _flags(torch)
    precision._FP32 = _Open()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        return fn()
    finally:
        precision._FP32 = saved
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags[:2]
        torch.set_float32_matmul_precision(flags[2])


def _embed_client(host, port, reqs):
    """One client thread: the /embed requests ``reqs`` (lists of texts) in turn."""
    from sonar_tpu_torch.client import SonarClient

    with SonarClient(host, port, timeout_s=300) as c:
        return [c.embed(texts) for texts in reqs]


def _speech_client(host, port, reqs):
    """One client thread: the /embed_speech requests ``reqs`` (lists of clips)."""
    from sonar_tpu_torch.client import SonarClient

    with SonarClient(host, port, timeout_s=300) as c:
        return [c.embed_speech(clips) for clips in reqs]


def _time_predict(pipe, sink):
    """Record the seconds of each ``pipe.predict`` call into ``sink`` until
    ``del pipe.predict`` (the server looks the method up at each call)."""
    predict = pipe.predict

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return predict(*args, **kwargs)
        finally:
            sink.append(time.perf_counter() - t0)

    pipe.predict = timed


def _endpoint_line(name, m, dt, card):
    return (f"serve /{name}: {m['requests']} requests, {m['items']} items in {dt:.2f} s = "
            f"{m['requests'] / dt:.1f} requests/s, {m['items'] / dt:.1f} items/s; latency p50 "
            f"{m['latency_p50_ms']} ms, p95 {m['latency_p95_ms']} ms; {m['batches']} batches, "
            f"mean occupancy {m['batch_occupancy_mean']} items; errors {m['errors']}; on {card}")


def _serve_at_full_width(torch, card, handoff, launches):
    """(j1): the three endpoints behind the port's server, fired at by the
    port's client from many threads."""
    import numpy as np

    from sonar_tpu_torch.client import SonarClient
    from sonar_tpu_torch.inference_pipelines.text import TextToTextModelPipeline
    from sonar_tpu_torch.serving import EmbeddingServer

    corpus, tok = handoff["corpus"], handoff["tokenizer"]
    embed_pipe = handoff["text_pipelines"]["int8"]
    translator = TextToTextModelPipeline(handoff["encoder"], handoff["decoders"]["bf16"], tok)
    speech_pipe = handoff["speech_pipelines"]["bf16"]
    rng = np.random.default_rng(10)
    requests = [[[corpus[i] for i in rng.integers(0, len(corpus), int(rng.integers(1, 33)))]
                 for _ in range(SERVE_REQUESTS)] for _ in range(SERVE_THREADS)]
    mid = [w for w in handoff["speech_clips"] if 3.0 <= w.shape[0] / 16000.0 <= 20.0]
    speech_requests = [[[mid[int(i)] for i in rng.integers(0, len(mid), 2)]
                        for _ in range(SPEECH_REQUESTS)] for _ in range(SPEECH_THREADS)]
    lone = [corpus[i] for i in rng.integers(0, len(corpus), 12)]
    to_translate = corpus[100:104]

    t0 = time.perf_counter()
    srv = EmbeddingServer(embed_pipe, max_wait_ms=10, warmup=True, translator=translator,
                          speech_pipeline=speech_pipe)
    log(f"serve: server built and warmed (every endpoint's serving shapes) in "
        f"{time.perf_counter() - t0:.1f} s")
    srv.start()
    host, port = srv.address
    failures = []
    served = dict.fromkeys(KERNELS, 0)  # the served calls' launches, summed
    try:
        with SonarClient(host, port, timeout_s=300) as client:
            got, _ = _counted(torch, served, lambda: client.embed(lone))
        direct = embed_pipe.predict(lone, source_lang="eng_Latn", batching="static")
        same = np.array_equal(got, direct)
        log(f"check serve /embed lone request of {len(lone)} sentences equals the pipeline's "
            f"direct static predict bit for bit {'ok' if same else 'FAIL'}")
        if not same:
            failures.append("lone /embed")

        before = {ep: m.snapshot() for ep, m in srv.metrics.items()}
        enc_before = embed_pipe.model.stats.snapshot()
        in_predict = {"embed": [], "embed_speech": []}
        _time_predict(embed_pipe, in_predict["embed"])
        _time_predict(speech_pipe, in_predict["embed_speech"])
        jobs = [(("embed", i), lambda r=r: _embed_client(host, port, r))
                for i, r in enumerate(requests)]
        jobs += [(("speech", i), lambda r=r: _speech_client(host, port, r))
                 for i, r in enumerate(speech_requests)]
        try:
            (replies, burst_s), _ = _counted(torch, served, lambda: _fire(jobs))
        finally:
            del embed_pipe.predict, speech_pipe.predict
        enc_after = embed_pipe.model.stats.snapshot()
        for ep, calls in in_predict.items():
            log(f"serve /{ep} burst: the worker was inside predict {sum(calls):.2f} s of the "
                f"{burst_s:.2f} s ({sum(calls) / burst_s:.1%}, {len(calls)} calls; wall time, "
                f"waits for the interpreter lock included); on {card}")

        # Each reply against the pipeline's direct predict (static batching,
        # all sentences in one call): a micro-batch of another size may take
        # another gate, so the limit is PERF.md's int8 / bf16 cosine.
        flat = [t for reqs in requests for texts in reqs for t in texts]
        want = embed_pipe.predict(flat, source_lang="eng_Latn", batching="static")
        got = np.concatenate([e for i in range(SERVE_THREADS) for e in replies["embed", i]])
        cos = _cos_rows(got, want)
        n_tok = max(len(tok.create_encoder(lang="eng_Latn")(t)) for t in flat)
        log(f"check serve /embed burst: {len(flat)} sentences (longest {n_tok} tokens) min "
            f"cos {cos.min():.6f} against direct predict (>= 0.999) "
            f"{'ok' if cos.min() >= 0.999 else 'FAIL'}")
        if cos.min() < 0.999 or n_tok < 256:
            failures.append("/embed burst")
        clips = [w for reqs in speech_requests for ws in reqs for w in ws]
        swant = speech_pipe.predict(clips)
        sgot = np.concatenate([e for i in range(SPEECH_THREADS) for e in replies["speech", i]])
        scos = _cos_rows(sgot, swant)
        log(f"check serve /embed_speech burst: {len(clips)} clips "
            f"({sum(w.shape[0] for w in clips) / 16000.0:.1f} s of audio) min cos "
            f"{scos.min():.6f} against direct predict (>= 0.999) "
            f"{'ok' if scos.min() >= 0.999 else 'FAIL'}")
        if scos.min() < 0.999:
            failures.append("/embed_speech burst")

        t0 = time.perf_counter()
        with SonarClient(host, port, timeout_s=300) as client:
            translated, _ = _counted(torch, served, lambda: client.translate(
                to_translate, source_lang="eng_Latn", target_lang="eng_Latn"))
        translate_s = time.perf_counter() - t0
        direct_t = translator.predict(to_translate, source_lang="eng_Latn",
                                      target_lang="eng_Latn")
        ok = translated == direct_t
        log(f"check serve /translate of {len(to_translate)} sentences alone ({translate_s:.2f} s, "
            f"default max_gen_len) equals direct predict {'ok' if ok else 'FAIL'}; lengths "
            f"{[len(t.split()) for t in translated]} words")
        if not ok:
            failures.append("/translate")
        for name in KERNELS:
            launches[name] += served[name]
        log(f"serve: launches of the served calls of (j1), the lone /embed, the burst and "
            f"/translate (threads share the counters): {served}")
        need = ("fused_int8_ffn", "flash_attention", "relpos_flash_attention_v2",
                "beam_masked_attend")
        missing = [n for n in need if served[n] == 0]
        if served["short_qkv_attention"] + served["fused_attn_block"] == 0:
            missing.append("short_qkv_attention or fused_attn_block")
        if missing:
            failures.append(f"no launch of {missing}")

        with SonarClient(host, port, timeout_s=60) as client:
            metrics = client.metrics()
            for ep, dt in (("embed", burst_s), ("embed_speech", burst_s),
                           ("translate", translate_s)):
                m = dict(metrics[ep])
                for key in ("requests", "items", "batches"):
                    m[key] -= before[ep][key]  # the burst's (or the lone translation's)
                log(_endpoint_line(ep, m, dt, card))
            enc = {k: enc_after[k] - enc_before[k]
                   for k in ("batches", "true_tokens", "padded_tokens")}
            log(f"serve /embed encoder over the burst: {enc['batches']} batches, padding waste "
                f"{1 - enc['true_tokens'] / enc['padded_tokens']:.4f} ({enc['true_tokens']} of "
                f"{enc['padded_tokens']} tokens real)")
            want_counts = {"embed": (1 + SERVE_THREADS * SERVE_REQUESTS, len(lone) + len(flat)),
                           "embed_speech": (SPEECH_THREADS * SPEECH_REQUESTS, len(clips)),
                           "translate": (1, len(to_translate))}
            counted = {ep: (metrics[ep]["requests"], metrics[ep]["items"]) for ep in want_counts}
            errors = sum(metrics[ep]["errors"] for ep in want_counts)
            ok = counted == want_counts and errors == 0
            log(f"check serve /metrics counts {counted} (want {want_counts}), errors {errors} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append("/metrics")
            srv.drain()
            status = client.healthz()["status"]
        log(f"check serve /healthz after drain(): {status} "
            f"{'ok' if status == 'draining' else 'FAIL'}")
        if status != "draining":
            failures.append("drain")
    finally:
        srv.stop(drain_timeout_s=30.0)
    return failures


def _serve_fp32_under_load(torch, card, handoff, launches):
    """(j2): two fp32 models served at once, TF32 switched on by the caller."""
    import numpy as np

    from sonar_tpu_torch.serving import EmbeddingServer

    corpus = handoff["corpus"]
    text_pipe = handoff["text_pipelines"]["fp32"]
    speech_pipe = handoff["speech_pipelines"]["fp32"]
    rng = np.random.default_rng(11)
    mid = [w for w in handoff["speech_clips"] if 3.0 <= w.shape[0] / 16000.0 <= 10.0]
    text_reqs = [[[corpus[int(i)] for i in rng.integers(0, len(corpus), int(rng.integers(1, 9)))]
                  for _ in range(2)] for _ in range(4)]
    speech_reqs = [[[mid[int(rng.integers(0, len(mid)))]] for _ in range(2)] for _ in range(4)]
    user = _flags(torch)
    torch.backends.cuda.matmul.allow_tf32 = True
    set_before = _flags(torch)
    srv = EmbeddingServer(text_pipe, max_wait_ms=10, speech_pipeline=speech_pipe).start()
    host, port = srv.address
    failures = []
    try:
        jobs = [(("text", i), lambda r=r: _embed_client(host, port, r))
                for i, r in enumerate(text_reqs)]
        jobs += [(("speech", i), lambda r=r: _speech_client(host, port, r))
                 for i, r in enumerate(speech_reqs)]
        (replies, dt), counts = _counted(torch, launches, lambda: _fire(jobs))
    finally:
        srv.stop(drain_timeout_s=30.0)
        after = _flags(torch)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = user[:2]
        torch.set_float32_matmul_precision(user[2])
    ok = after == set_before
    log(f"check serve fp32 text + fp32 speech at once (4 + 4 threads, 8 + 8 requests in "
        f"{dt:.2f} s): the flags read {after} after, {set_before} before {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("fp32 flags")
    # The limit, 1e-4 of the scale, sits between the sound runs' readings
    # (~1e-6 to ~2e-5 of it) and the same direct predict with the scope
    # switched off and TF32 on, which must read above it.
    for kind, reqs, pipe in (("text", text_reqs, text_pipe), ("speech", speech_reqs, speech_pipe)):
        items = [x for r in reqs for req in r for x in req]
        got = np.concatenate([e for i in range(4) for e in replies[kind, i]])
        predict = ((lambda: pipe.predict(items, source_lang="eng_Latn", batching="static"))
                   if kind == "text" else (lambda: pipe.predict(items)))
        want = predict()
        tf32 = _tf32_control(torch, predict)
        max_abs, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        tf32_abs = float(np.abs(tf32 - want).max())
        ok = max_abs <= FP32_SERVE_LIMIT * scale < tf32_abs
        log(f"check serve fp32 {kind}: {len(items)} items max_abs {max_abs:.3e} against direct "
            f"fp32 predict (<= {FP32_SERVE_LIMIT:g} x scale {scale:.3g}); the TF32 control reads "
            f"{tf32_abs:.3e} (must exceed the limit) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"fp32 {kind}")
    log(f"serve fp32: launches {counts}")
    return failures


def _packed_encoding(torch, card, handoff, launches):
    """(j3): the corpus packed into rows of 128 through ``apply_packed``, in
    int8 and bf16, against static batching on the same sentences."""
    import numpy as np

    from sonar_tpu_torch.assets.convert import text_encoder_from_numpy
    from sonar_tpu_torch.data.batcher import StaticShapeBatcher
    from sonar_tpu_torch.data.packing import pack_sequences
    from sonar_tpu_torch.inference_pipelines.text import TorchTextEncoder, _static_len_buckets_for
    from sonar_tpu_torch.models.sonar_text import sonar_text_encoder_archs
    from sonar_tpu_torch.ops.precision import matmul_precision_for
    from sonar_tpu_torch.utils.flops import mfu, transformer_encoder_flops

    cfg = sonar_text_encoder_archs.get("basic")
    encode = handoff["tokenizer"].create_encoder(lang="eng_Latn")
    ids = [list(encode(t)) for t in handoff["corpus"]]
    fits = [i for i, x in enumerate(ids) if len(x) <= PACK_ROW_LEN]
    packed = list(pack_sequences(ids, row_len=PACK_ROW_LEN, rows_per_batch=PACK_ROWS,
                                 max_segments=PACK_SEGMENTS))
    fit_ids = [ids[i] for i in fits]
    fit_packed = list(pack_sequences(fit_ids, row_len=PACK_ROW_LEN, rows_per_batch=PACK_ROWS,
                                     max_segments=PACK_SEGMENTS))
    real = sum(len(x) for x in fit_ids)
    packed_waste = 1.0 - real / (len(fit_packed) * PACK_ROWS * PACK_ROW_LEN)
    batcher = StaticShapeBatcher(pad_value=1, len_buckets=_static_len_buckets_for(
        cfg.max_seq_len), tokens_per_batch=8192)
    static_batches = list(batcher.batches(fit_ids))
    static_waste = 1.0 - real / sum(b.seqs.size for b in static_batches)
    log(f"packed: {len(ids)} sentences into {len(packed)} batches of [{PACK_ROWS}, "
        f"{PACK_ROW_LEN}] (up to {PACK_SEGMENTS} a row); {len(ids) - len(fits)} sentences are "
        f"longer than {PACK_ROW_LEN} tokens and truncated by the packer (left out of the "
        f"comparisons)")

    def to_device(b, device):
        return [torch.from_numpy(a).to(device) for a in (b.tokens, b.segment_ids, b.positions)]

    def run(model, batches):
        with torch.inference_mode(), matmul_precision_for(model.dtype):
            return [model.apply_packed(model.params.tree(), *args, PACK_SEGMENTS)
                    for args in batches]

    def flops_of(shapes):
        return sum(transformer_encoder_flops(cfg.model_dim, cfg.ffn_inner_dim,
                                             cfg.num_encoder_layers, b, s) for b, s in shapes)

    failures = []
    cpu_base = text_encoder_from_numpy(handoff["text_params"], cfg, torch.bfloat16, "cpu")
    for mode, quantize in (("int8", True), ("bf16", False)):
        enc = handoff["text_pipelines"][mode].model
        model = enc.model
        on_card = [to_device(b, DEVICE) for b in packed]
        run(model, on_card[:1])  # warm
        outs, counts = _counted(torch, launches, lambda: run(model, on_card))
        outs = [o.cpu().numpy() for o in outs]
        finite = all(np.isfinite(o).all() for o in outs)
        emb = np.zeros((len(ids), cfg.model_dim), np.float32)
        for b, o in zip(packed, outs):
            for orig, row, seg in b.mapping:
                emb[orig] = o[row, seg - 1]
        cos = _cos_rows(emb[fits], handoff["static_embeddings"][mode][fits])
        ok = (finite and counts["flash_attention"] > 0
              and (counts["fused_int8_ffn"] > 0 or mode == "bf16") and cos.min() >= 0.999)
        log(f"check packed {mode}: launches flash_attention {counts['flash_attention']} (full "
            f"bias), fused_int8_ffn {counts['fused_int8_ffn']}; outputs finite {finite}; "
            f"{len(fits)} sentences of <= {PACK_ROW_LEN} tokens against their static-batch "
            f"embedding on the card: min cos {cos.min():.6f} (>= 0.999) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"packed {mode}")

        # Encode only, the same sentences: packed rows against static batches.
        fit_dev = [to_device(b, DEVICE) for b in fit_packed]
        run(model, fit_dev[:1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(model, fit_dev)
        torch.cuda.synchronize()
        packed_s = time.perf_counter() - t0
        enc.encode_batches(static_batches[:1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc.encode_batches(static_batches)
        torch.cuda.synchronize()
        static_s = time.perf_counter() - t0
        peak = "int8" if quantize else "bf16"
        pf = flops_of([(PACK_ROWS, PACK_ROW_LEN)] * len(fit_packed))
        sf = flops_of([b.seqs.shape for b in static_batches])
        log(f"packed {mode} encode only, {len(fit_ids)} sentences: packed {len(fit_ids) / packed_s:.1f} "
            f"sentences/s ({len(fit_packed)} batches, padding waste {packed_waste:.4f}, MFU "
            f"{mfu(pf / packed_s, peak):.4f}) against static {len(fit_ids) / static_s:.1f} "
            f"sentences/s ({len(static_batches)} batches, padding waste {static_waste:.4f}, MFU "
            f"{mfu(sf / static_s, peak):.4f}); MFU of the analytic matmul FLOPs of the padded "
            f"shapes over the H100 SXM's dense {peak} peak; on {card}")

        # PACK_CPU_ROWS rows of the first batch, and of the last batch where its
        # sentences end and its wholly padded rows (every query's keys masked)
        # begin, on the CPU port. Rows attend only within themselves.
        cpu_model = TorchTextEncoder(cpu_base, quantize=quantize, device="cpu").model
        used = 1 + max(row for _, row, _ in packed[-1].mapping)
        last = min(max(used - PACK_CPU_ROWS // 2, 0), PACK_ROWS - PACK_CPU_ROWS)
        for b, start in ((0, 0), (len(packed) - 1, last)):
            t0 = time.perf_counter()
            rows = slice(start, start + PACK_CPU_ROWS)
            want = run(cpu_model, [[a[rows] for a in to_device(packed[b], "cpu")]])[0].numpy()
            got = outs[b][rows]
            filled = np.zeros(got.shape[:2], bool)
            for _, row, seg in packed[b].mapping:
                if start <= row < start + PACK_CPU_ROWS:
                    filled[row - start, seg - 1] = True
            padded = int((packed[b].segment_ids[rows] == 0).all(axis=1).sum())
            cos = _cos_rows(got[filled], want[filled])
            ok = (cos.min() >= 0.999 and np.isfinite(want).all()
                  and (got[~filled] == 0).all() and (want[~filled] == 0).all())
            log(f"check packed {mode} card vs CPU on rows {start}-{start + PACK_CPU_ROWS - 1} of "
                f"batch {b} ({int(filled.sum())} sentences, {padded} rows wholly padding): min "
                f"cos {cos.min():.6f} (>= 0.999), empty segments 0 on both "
                f"{'ok' if ok else 'FAIL'} (CPU {time.perf_counter() - t0:.1f} s)")
            if not ok:
                failures.append(f"packed {mode} card vs CPU, batch {b}")
        del cpu_model
    return failures


def _hf_layer(torch, card, handoff, launches):
    """(j4): the HF batch layer's ``process_batch`` on plain dicts (the
    card's machine has no ``datasets``)."""
    import numpy as np

    from sonar_tpu_torch.huggingface.audio import (
        HFAudioToEmbeddingPipeline,
        HFAudioToEmbeddingPipelineConfig,
    )
    from sonar_tpu_torch.huggingface.text import (
        HFEmbeddingToTextPipeline,
        HFEmbeddingToTextPipelineConfig,
        HFTextToEmbeddingPipeline,
        HFTextToEmbeddingPipelineConfig,
    )
    from sonar_tpu_torch.inference_pipelines.text import EmbeddingToTextModelPipeline

    tok, corpus = handoff["tokenizer"], handoff["corpus"]
    text_pipe = handoff["text_pipelines"]["int8"]
    dim = text_pipe.model.model_dim
    failures = []
    served = dict.fromkeys(KERNELS, 0)  # the process_batch calls' launches, summed

    flat = corpus[:256]
    nested = [corpus[256 + 3 * i: 256 + 3 * i + 1 + i % 3] for i in range(256)]
    flat_nested = [t for row in nested for t in row]
    hf = HFTextToEmbeddingPipeline(HFTextToEmbeddingPipelineConfig(
        columns=["text", "sents"], encoder_model=text_pipe.model, tokenizer=tok))
    t0 = time.perf_counter()
    out, _ = _counted(torch, served, lambda: hf.process_batch({"text": flat, "sents": nested}))
    dt = time.perf_counter() - t0
    same = (np.array_equal(np.asarray(out["text_output"], np.float32),
                           text_pipe.predict(flat, source_lang="eng_Latn", batch_size=32))
            and np.array_equal(np.concatenate([np.asarray(r, np.float32).reshape(-1, dim)
                                               for r in out["sents_output"]]),
                               text_pipe.predict(flat_nested, source_lang="eng_Latn",
                                                 batch_size=32)))
    log(f"check hf text->embedding: 256 rows flat + 256 rows of 1-3 sentences "
        f"({len(flat) + len(flat_nested)} sentences) in {dt:.2f} s = {512 / dt:.1f} rows/s; "
        f"equal bits to direct predict (the same batches of 32) {'ok' if same else 'FAIL'}; "
        f"on {card}")
    if not same:
        failures.append("hf text->embedding")

    dec = handoff["decoders"]["bf16"]
    emb = handoff["embeddings"][:8]
    hf = HFEmbeddingToTextPipeline(HFEmbeddingToTextPipelineConfig(
        columns=["emb"], decoder_model=dec, tokenizer=tok, max_seq_len=DECODE_KW["max_gen_len"]))
    t0 = time.perf_counter()
    out = _counted(torch, served, lambda: hf.process_batch({"emb": list(emb)}))[0]["emb_output"]
    dt = time.perf_counter() - t0
    want = EmbeddingToTextModelPipeline(dec, tok).predict(
        emb, target_lang="eng_Latn", batch_size=32, max_seq_len=DECODE_KW["max_gen_len"])
    same = out == want
    log(f"check hf embedding->text: 8 rows in {dt:.2f} s = {8 / dt:.2f} rows/s; equal to direct "
        f"predict {'ok' if same else 'FAIL'}; on {card}")
    if not same:
        failures.append("hf embedding->text")

    speech_pipe = handoff["speech_pipelines"]["bf16"]
    clips = [w for w in handoff["speech_clips"] if w.shape[0] <= 20 * 16000][:8]
    hf = HFAudioToEmbeddingPipeline(HFAudioToEmbeddingPipelineConfig(
        columns=["audio"], encoder_model=speech_pipe.model))
    rows = [{"array": w, "sampling_rate": 16000} for w in clips]
    t0 = time.perf_counter()
    out, _ = _counted(torch, served, lambda: hf.process_batch({"audio": rows}))
    dt = time.perf_counter() - t0
    got = np.asarray(out["audio_output"], np.float32)
    same = np.array_equal(got, speech_pipe.predict(clips, batch_size=4, n_parallel=2))
    log(f"check hf audio->embedding: {len(clips)} clips in {dt:.2f} s = {len(clips) / dt:.2f} "
        f"rows/s; equal bits to "
        f"direct predict (the same batches of 4) {'ok' if same else 'FAIL'}; on {card}")
    if not same:
        failures.append("hf audio->embedding")
    for name in KERNELS:
        launches[name] += served[name]
    log(f"hf: launches of the three process_batch calls {served}")
    return failures


def run_serving(torch, card, handoff):
    """Phase (j): (j1) the server at full width, (j2) two fp32 models
    served at once, (j3) packed encoding, (j4) the HF layer. Reuses the
    models of (d), (e) and (f). Returns the launch counts of its driven
    runs."""
    launches = dict.fromkeys(KERNELS, 0)
    failures = []
    for label, part in (("(j1)", _serve_at_full_width), ("(j2)", _serve_fp32_under_load),
                        ("(j3)", _packed_encoding), ("(j4)", _hf_layer)):
        t0 = time.perf_counter()
        failures += part(torch, card, handoff, launches)
        log(f"part {label} took {time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError(f"serving checks failed: {failures}")
    return launches


# -- (k) training on the card ----------------------------------------------------------------

TRAIN_WARMUP, TRAIN_STEPS = 2, 5  # (k1), (k2): steps before the timed ones, timed steps
TRAIN_BATCH, TRAIN_LEN = 16, 64  # (k1): source / target pairs and their length
TRAIN_LR = 1e-4  # AdamW's rate in (k1) and (k2) (decay 1e-2, torch's fused update)
TRAIN_LOSS_LIMIT = 1e-5  # (k4): the card's loss against the CPU's, x the CPU's
# (k4): each gradient leaf against the CPU's, x its scale. Set from a first
# reading on an NVIDIA H100 80GB HBM3 (700 W): the worst sound leaf read
# 4.7e-4 (the decoder's final LayerNorm bias, behind the tied projection's
# 256,206-term fp32 reductions, which the card and the CPU sum in other
# orders), the TF32 control 2.3e-2.
TRAIN_GRAD_LIMIT = 2e-3
K4_ROWS = 4  # (k4)'s batch rows


def _card_tree(torch, tree, device=None):
    """A tree of numpy arrays as fp32 tensors on ``device`` (the card)."""
    return {k: _card_tree(torch, v, device) if isinstance(v, dict)
            else torch.from_numpy(v).to(device or DEVICE) for k, v in tree.items()}


def _first_layers(tree, n):
    """A JAX-layout tree whose stacked ``layers`` keep their first ``n``."""
    def cut(node):
        return {k: cut(v) if isinstance(v, dict) else v[:n] for k, v in node.items()}
    return {k: cut(v) if k == "layers" else (_first_layers(v, n) if isinstance(v, dict) else v)
            for k, v in tree.items()}


def _translation_batch(torch, handoff, rows, device):
    """``rows`` sentences of (d)'s corpus with at least 65 tokens, each its
    own target (auto-encoding through the bottleneck): source the first 64
    tokens, decoder input EOS + the first 63, labels the first 64."""
    encode = handoff["tokenizer"].create_encoder(lang="eng_Latn")
    long = (x[:TRAIN_LEN] for x in (list(encode(t)) for t in handoff["corpus"])
            if len(x) > TRAIN_LEN)
    ids = list(itertools.islice(long, rows))
    if len(ids) < rows:
        raise RuntimeError(f"the corpus has {len(ids)} sentences of more than {TRAIN_LEN} tokens")
    src = torch.tensor(ids, dtype=torch.int64)
    lens = torch.full((rows,), TRAIN_LEN, dtype=torch.int64)
    tgt_in = torch.cat([torch.full((rows, 1), 3, dtype=torch.int64), src[:, :-1]], dim=1)
    batch = {"src_tokens": src, "src_lens": lens, "tgt_in": tgt_in, "tgt_out": src,
             "tgt_lens": lens}
    return {k: v.to(device) for k, v in batch.items()}


def _translation_flops(ecfg, dcfg, b, s, t):
    """Matmul FLOPs of one ``translation_loss`` forward (``utils/flops.py``'s
    conventions): the encoder at [b, s]; the decoder at [b, t], its layers
    self-attention QKVO 8 D^2, cross-attention Q and O 4 D^2 (K and V of the
    one memory row are negligible), FFN 4 D F a token and 4 t D a token of
    self-attention scores and PV; the tied projection 2 D V a token."""
    from sonar_tpu_torch.utils.flops import transformer_encoder_flops

    d, f, n, v = dcfg.model_dim, dcfg.ffn_inner_dim, dcfg.num_decoder_layers, dcfg.vocab_info.size
    enc = transformer_encoder_flops(ecfg.model_dim, ecfg.ffn_inner_dim, ecfg.num_encoder_layers,
                                    b, s)
    dec = b * t * (n * (12 * d * d + 4 * d * f + 4 * t * d) + 2 * d * v)
    return enc + dec


def _timed_steps(torch, card, label, state, step, batch, gen, n_tokens, flops):
    """TRAIN_WARMUP then TRAIN_STEPS steps, each ended by reading its loss
    (a host sync), then one more under torch.profiler. Prints ms a step,
    tokens/s, MFU (3 x the forward's FLOPs over the bf16 peak), the peak
    device memory and the profiled step's busy share and top device
    operations. The launch counts over all the steps must read 0 and the
    loss must fall over the timed ones. Returns (failures, counts)."""
    from sonar_tpu_torch.utils.flops import mfu

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero_launches()
    losses, times = [], []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, batch, gen)
        loss = float(loss)
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
    ops, wall, _ = _device_profile(torch, lambda: step(state, batch, gen))
    counts = read_launches()
    ms = sum(times) / len(times)
    log(f"train {label}: {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up: ms a step "
        f"{[round(t, 3) for t in times]}, mean {ms:.3f}; {n_tokens / ms * 1e3:.1f} tokens/s; "
        f"MFU {mfu(3 * flops / (ms / 1e3)):.4f} (3 x {flops / 1e12:.3f} TFLOP a step); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({held / 2**30:.2f} "
        f"GiB allocated before the first step: earlier phases' models and these parameters), "
        f"on {card}")
    busy = sum(ms for ms, _ in ops.values())
    log(f"train {label}: one more step under torch.profiler: device busy {busy:.2f} ms of "
        f"{wall:.2f} ms wall = {busy / wall:.3f} busy share, "
        f"{sum(n for _, n in ops.values())} device operations" if ops else
        f"train {label}: the profiler saw no device time (busy share not measured)")
    for name, (op_ms, n) in sorted(ops.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"train {label} device time: {op_ms:9.3f} ms {100 * op_ms / busy:5.1f}% {n:6d} calls "
            f"{name[:90]}")
    failures = []
    falls = all(x == x for x in losses) and losses[-1] < losses[0]
    log(f"check train {label}: losses {[round(x, 4) for x in losses]} fall "
        f"{'ok' if falls else 'FAIL'}; launches {counts} all 0 "
        f"{'ok' if not any(counts.values()) else 'FAIL'}")
    if not falls:
        failures.append(f"{label} loss")
    if any(counts.values()):
        failures.append(f"{label} launches")
    return failures, counts


def _train_translation(torch, card, handoff, launches):
    """(k1): ``translation_loss`` on the full-width ``basic`` encoder and
    decoder, fp32 leaves (q/k/v fused) under AdamW, bf16 compute, dropout
    from a seeded generator on the card."""
    from sonar_tpu_torch.models.sonar_text import (
        SonarTextEncoder, sonar_text_decoder_archs, sonar_text_encoder_archs)
    from sonar_tpu_torch.nn.conditional_decoder import ConditionalTransformerDecoder
    from sonar_tpu_torch.nn.transformer import fuse_qkv
    from sonar_tpu_torch.training import init_train_state, make_train_step, translation_loss

    ecfg, dcfg = sonar_text_encoder_archs.get("basic"), sonar_text_decoder_archs.get("basic")
    tree = {"encoder": fuse_qkv(_card_tree(torch, handoff["text_params"]), keep_split=False),
            "decoder": fuse_qkv(_card_tree(torch, handoff["decoder_params"]), keep_split=False)}
    encoder = SonarTextEncoder(ecfg, tree["encoder"], dtype=torch.bfloat16)
    decoder = ConditionalTransformerDecoder(dcfg, tree["decoder"], dtype=torch.bfloat16)
    state = init_train_state(tree, lambda leaves: torch.optim.AdamW(
        leaves, lr=TRAIN_LR, weight_decay=1e-2, fused=True))
    n_params = sum(t.numel() for t in state.optimizer.param_groups[0]["params"])
    step = make_train_step(lambda p, b, g: translation_loss(encoder, decoder, p["encoder"],
                                                            p["decoder"], b, g))
    batch = _translation_batch(torch, handoff, TRAIN_BATCH, DEVICE)
    log(f"train (k1): basic encoder + decoder, {n_params / 1e9:.3f} B fp32 parameters, AdamW, "
        f"bf16 compute, dropout {ecfg.emb_dropout_p}; batch {TRAIN_BATCH} x {TRAIN_LEN} source "
        f"and target tokens")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    flops = _translation_flops(ecfg, dcfg, TRAIN_BATCH, TRAIN_LEN, TRAIN_LEN)
    failures, counts = _timed_steps(torch, card, "(k1) translation", state, step, batch, gen,
                                    2 * TRAIN_BATCH * TRAIN_LEN, flops)
    for name in KERNELS:
        launches[name] += counts[name]
    return failures


def _train_distillation(torch, card, handoff, launches):
    """(k2): ``distillation_loss`` (mse) of the full-width ``english``
    Conformer towards (d)'s bf16 text embeddings, fp32 leaves under AdamW,
    bf16 compute, on 4 clips of 5-10 s."""
    import numpy as np

    from sonar_tpu_torch.models.sonar_speech import SonarSpeechEncoder, sonar_speech_encoder_archs
    from sonar_tpu_torch.ops.fbank import FbankConfig, batched_fbank, num_frames
    from sonar_tpu_torch.training import distillation_loss, init_train_state, make_train_step
    from sonar_tpu_torch.utils.flops import conformer_encoder_flops

    cfg = sonar_speech_encoder_archs.get("english")
    c = cfg.conformer
    rng = np.random.default_rng(21)
    clips = [_clip(rng, s) for s in rng.uniform(5.0, 10.0, 4)]
    waves = np.zeros((len(clips), max(w.shape[0] for w in clips)), np.float32)
    for i, w in enumerate(clips):
        waves[i, :w.shape[0]] = w
    fcfg = FbankConfig(num_mel_bins=cfg.frontend.num_fbank_channels)
    with torch.no_grad():
        feats, frame_lens = batched_fbank(
            torch.from_numpy(waves).to(DEVICE),
            torch.tensor([w.shape[0] for w in clips], device=DEVICE),
            num_frames(waves.shape[1], fcfg), fcfg)
    batch = {"inputs": feats, "lens": frame_lens,
             "teacher_emb": torch.from_numpy(handoff["embeddings"][:len(clips)]).to(DEVICE)}
    tree = _card_tree(torch, handoff["speech_params"])
    model = SonarSpeechEncoder(cfg, tree, dtype=torch.bfloat16)
    state = init_train_state(tree, lambda leaves: torch.optim.AdamW(
        leaves, lr=TRAIN_LR, weight_decay=1e-2, fused=True))
    n_params = sum(t.numel() for t in state.optimizer.param_groups[0]["params"])
    step = make_train_step(lambda p, b, g: distillation_loss(model, p, b, objective="mse"))
    s = feats.shape[1] // cfg.frontend.fbank_stride
    log(f"train (k2): english Conformer, {n_params / 1e9:.3f} B fp32 parameters, AdamW, bf16 "
        f"compute; {len(clips)} clips of {[round(w.shape[0] / 16000, 2) for w in clips]} s "
        f"(S {s} padded), teachers from (d)'s bf16 pipeline")
    flops = conformer_encoder_flops(c.model_dim, c.ffn_inner_dim, c.num_layers,
                                    c.depthwise_kernel_size, len(clips), s)
    n_tokens = int((frame_lens // cfg.frontend.fbank_stride).sum())
    failures, counts = _timed_steps(torch, card, "(k2) distillation", state, step, batch, None,
                                    n_tokens, flops)
    for name in KERNELS:
        launches[name] += counts[name]
    return failures


def _train_classifier(torch, card, handoff, launches):
    """(k3): MuTox's head (``mutox``: 1024 -> 512 -> 128 -> 1) trained for 3
    Adam steps on (d)'s bf16 ``basic`` encoder, frozen: its forward runs
    under no_grad and may launch the kernels; its leaves stay bit for bit."""
    import numpy as np

    from sonar_tpu_torch.assets.convert import init_mutox_params, mutox_from_numpy
    from sonar_tpu_torch.models.mutox import mutox_archs
    from sonar_tpu_torch.nn.core import tree_leaves
    from sonar_tpu_torch.training import (
        classifier_loss, init_train_state, make_train_step)

    encoder = handoff["encoder"].model
    mcfg = mutox_archs.get("mutox")
    head = mutox_from_numpy(init_mutox_params(mcfg, seed=0), mcfg, device=DEVICE)
    params = {"encoder": encoder.params.tree(), "head": head.params.tree()}
    frozen = [t.clone() for t in tree_leaves(params["encoder"])]
    head_before = [t.clone() for t in tree_leaves(params["head"])]
    encode = handoff["tokenizer"].create_encoder(lang="eng_Latn")
    ids = list(itertools.islice((x for x in (list(encode(t)) for t in handoff["corpus"])
                                 if 20 <= len(x) <= 128), 16))
    s = max(len(x) for x in ids)
    tokens = torch.ones((len(ids), s), dtype=torch.int64)
    for i, x in enumerate(ids):
        tokens[i, :len(x)] = torch.tensor(x)
    rng = np.random.default_rng(5)
    batch = {"tokens": tokens.to(DEVICE), "lens": torch.tensor([len(x) for x in ids],
                                                                device=DEVICE),
             "labels": torch.from_numpy(rng.integers(0, 2, len(ids))).to(DEVICE)}
    state = init_train_state(params, lambda leaves: torch.optim.Adam(leaves, lr=1e-3))
    step = make_train_step(lambda p, b, g: classifier_loss(encoder, head, p, b, g))
    try:
        torch.cuda.synchronize()
        zero_launches()
        losses = []
        for _ in range(3):
            state, loss = step(state, batch)
            losses.append(float(loss))
        torch.cuda.synchronize()
        counts = read_launches()
    finally:
        for t in tree_leaves(params):
            t.requires_grad_(False)
    for name in KERNELS:
        launches[name] += counts[name]
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(params["encoder"]), frozen))
    moved = any(not torch.equal(a, b) for a, b in zip(tree_leaves(params["head"]), head_before))
    short = counts["short_qkv_attention"]
    ok = same and moved and short > 0
    log(f"check train (k3) frozen-encoder classifier: {len(ids)} sentences at S {s}, 3 steps, "
        f"losses {[round(x, 4) for x in losses]}; launches {counts} (short_qkv_attention "
        f"{short} > 0: the frozen forward is inference); encoder bit-identical {same}, head "
        f"changed {moved} {'ok' if ok else 'FAIL'}")
    return [] if ok else ["(k3) frozen classifier"]


def _leaf_paths(tree, prefix=""):
    """The paths of a tree's leaves in ``tree_leaves``' order (sorted keys,
    depth first)."""
    out = []
    for key in sorted(tree):
        path = f"{prefix}/{key}"
        out += _leaf_paths(tree[key], path) if isinstance(tree[key], dict) else [path]
    return out


# Leaves whose gradient is zero in exact arithmetic: cross-attention on a
# one-row memory is output_proj(v_proj(memory)) whatever its query and key
# (the softmax over one key is 1), so its q and k projections read as
# rounding noise on both sides.
ZERO_GRAD = ("/encoder_decoder_attn/q_proj/", "/encoder_decoder_attn/k_proj/")


def _k4_step(torch, handoff, device, mesh=None):
    """One step of (k4)'s model: the ``basic`` encoder and decoder cut to 2
    layers each, full width, fp32 leaves, q/k/v fused, SGD at rate 0 (the
    gradients, the leaves unchanged), dropout off, on 4 x 64 rows of the
    corpus; over ``mesh`` if given. -> (loss, the gradients in
    ``tree_leaves`` order on the CPU, their paths)."""
    import dataclasses

    from sonar_tpu_torch.models.sonar_text import (
        SonarTextEncoder, sonar_text_decoder_archs, sonar_text_encoder_archs)
    from sonar_tpu_torch.nn.conditional_decoder import ConditionalTransformerDecoder
    from sonar_tpu_torch.nn.core import tree_leaves
    from sonar_tpu_torch.nn.transformer import fuse_qkv
    from sonar_tpu_torch.training import init_train_state, make_train_step, translation_loss

    ecfg = dataclasses.replace(sonar_text_encoder_archs.get("basic"), num_encoder_layers=2)
    dcfg = dataclasses.replace(sonar_text_decoder_archs.get("basic"), num_decoder_layers=2)
    tree = {"encoder": fuse_qkv(_card_tree(torch, _first_layers(handoff["text_params"], 2),
                                           device), keep_split=False),
            "decoder": fuse_qkv(_card_tree(torch, _first_layers(handoff["decoder_params"], 2),
                                           device), keep_split=False)}
    paths = _leaf_paths(tree)
    encoder = SonarTextEncoder(ecfg, tree["encoder"])
    decoder = ConditionalTransformerDecoder(dcfg, tree["decoder"])
    state = init_train_state(tree, lambda leaves: torch.optim.SGD(leaves, lr=0.0), mesh=mesh)
    step = make_train_step(lambda p, b, g: translation_loss(encoder, decoder, p["encoder"],
                                                            p["decoder"], b, g), mesh)
    _, loss = step(state, _translation_batch(torch, handoff, K4_ROWS, device))
    return float(loss), [t.grad.cpu() for t in tree_leaves(state.params)], paths


def _grad_errors(paths, got, want, zero=ZERO_GRAD):
    """{path: error / scale} over the gradient leaves (the scale: the
    reference's max-abs, floored at a thousandth of the largest leaf's); the
    ``zero`` leaves by their max-abs over the largest leaf's."""
    top = max(w.abs().max().item() for w in want)
    out = {}
    for path, g, w in zip(paths, got, want):
        if any(z in path for z in zero):
            out[path] = max(g.abs().max().item(), w.abs().max().item()) / top
        else:
            out[path] = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-3 * top)
    return out


def _train_card_vs_cpu(torch, card, handoff, launches):
    """(k4): one fp32 ``translation_loss`` step of ``_k4_step``'s model on the
    card and on the CPU port: the same weights and batch. The loss within
    TRAIN_LOSS_LIMIT of the CPU's; every gradient leaf within
    TRAIN_GRAD_LIMIT of its scale (its CPU max-abs, floored at a thousandth
    of the largest leaf's), but the ZERO_GRAD leaves, which must read zero
    at that resolution on both (max-abs within TRAIN_GRAD_LIMIT of the
    largest leaf's). A TF32 control (the fp32 scope switched off, TF32 on)
    must read worse than the limit."""
    t0 = time.perf_counter()
    (loss, on_card, paths), counts = _counted(torch, launches,
                                              lambda: _k4_step(torch, handoff, DEVICE))
    handoff["k4_loss"] = loss
    tf32_loss, tf32, _ = _tf32_control(torch, lambda: _k4_step(torch, handoff, DEVICE))
    cpu_loss, on_cpu, _ = _k4_step(torch, handoff, "cpu")
    loss_err, tf32_loss_err = (abs(x - cpu_loss) / abs(cpu_loss) for x in (loss, tf32_loss))
    err, tf32_err = _grad_errors(paths, on_card, on_cpu), _grad_errors(paths, tf32, on_cpu)
    worst = sorted(err.items(), key=lambda kv: -kv[1])[:3]
    ok = (loss_err <= TRAIN_LOSS_LIMIT and max(err.values()) <= TRAIN_GRAD_LIMIT
          < max(tf32_err.values()) and not any(counts.values()))
    log(f"check train (k4) card vs CPU, fp32, 2 + 2 layers at full width, {K4_ROWS} x "
        f"{TRAIN_LEN}: loss {loss:.6f} against {cpu_loss:.6f} (rel {loss_err:.3e} <= "
        f"{TRAIN_LOSS_LIMIT:g}); {len(on_cpu)} gradient leaves, worst "
        f"{[(p, f'{e:.3e}') for p, e in worst]} of the scale (<= {TRAIN_GRAD_LIMIT:g}); the "
        f"TF32 control reads {max(tf32_err.values()):.3e} (loss rel {tf32_loss_err:.3e}; must "
        f"exceed the limit); launches {counts} ({time.perf_counter() - t0:.1f} s) "
        f"{'ok' if ok else 'FAIL'}")
    return [] if ok else ["(k4) card vs CPU"]


def run_training(torch, card, handoff):
    """Phase (k): (k1) translation, (k2) distillation, (k3) a frozen-encoder
    classifier, (k4) one step on the card against the CPU. Each step of
    (k1), (k2) and (k4) runs with autograd recording, so no kernel may
    launch; (k3)'s frozen forward is inference. (k1)'s state is freed before
    (k2). Returns the launch counts of its runs."""
    launches = dict.fromkeys(KERNELS, 0)
    failures = []
    for label, part in (("(k1)", _train_translation), ("(k2)", _train_distillation),
                        ("(k3)", _train_classifier), ("(k4)", _train_card_vs_cpu)):
        t0 = time.perf_counter()
        failures += part(torch, card, handoff, launches)
        torch.cuda.empty_cache()
        log(f"part {label} took {time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError(f"training checks failed: {failures}")
    return launches


# -- (l) scale-out over torch.distributed, in child processes -----------------------

SCALEOUT_DIR = REPO / "build" / "chip_smoke" / "scaleout"
SCALEOUT_TIMEOUT = 600  # seconds a child may take
SCALEOUT_TEXT = 64  # (l2)'s model-split encodes: sentences of (d)'s corpus
SCALEOUT_COS = {"bf16": 0.999, "int8": 0.999}  # (l2) model 2: cosine per sentence against (d)


class _Checks:
    """A child's checks: each logged with its time, kept for its JSON line."""

    def __init__(self, card):
        self.card, self.rows = card, []

    def add(self, name, ok, detail, t0):
        dt = time.perf_counter() - t0
        log(f"check {name}: {detail} ({dt:.2f} s, on {self.card}) {'ok' if ok else 'FAIL'}")
        self.rows.append({"name": name, "ok": bool(ok), "s": round(dt, 3), "detail": detail})


def _scaleout_handoff(torch, workdir, decoder=True):
    """What (d), (f) and (k4) drew from their seeds, drawn again: the
    tokenizer (written into ``workdir``, the child's own, since the children
    run at once), the corpus and both models' numpy weights (the encoder's
    alone without ``decoder``)."""
    import numpy as np

    from sonar_tpu_torch.assets.convert import init_text_decoder_params, init_text_encoder_params
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs, sonar_text_encoder_archs

    rng = np.random.default_rng(0)
    workdir.mkdir(parents=True, exist_ok=True)
    tokenizer, words = _tokenizer(workdir, rng)
    handoff = {"tokenizer": tokenizer, "corpus": _corpus(rng, words, N_SENTENCES),
               "text_params": init_text_encoder_params(sonar_text_encoder_archs.get("basic"),
                                                       seed=0)}
    if decoder:
        handoff["decoder_params"] = init_text_decoder_params(
            sonar_text_decoder_archs.get("basic"), seed=0)
    return handoff


def _text_pipeline(torch, handoff, dtype, quantize, mesh):
    from sonar_tpu_torch.assets.convert import text_encoder_from_numpy
    from sonar_tpu_torch.inference_pipelines.text import (
        TextToEmbeddingModelPipeline,
        TorchTextEncoder,
    )
    from sonar_tpu_torch.models.sonar_text import sonar_text_encoder_archs

    model = text_encoder_from_numpy(handoff["text_params"], sonar_text_encoder_archs.get("basic"),
                                    dtype, DEVICE)
    return TextToEmbeddingModelPipeline(
        TorchTextEncoder(model, fuse_qkv=True, quantize=quantize, device=DEVICE, mesh=mesh),
        handoff["tokenizer"])


def _scaleout_l1(torch, checks, ref, handoff, launches):
    """(l1): world 1 over NCCL, every check bit for bit against the phase it
    repeats."""
    import numpy as np

    from sonar_tpu_torch.assets.convert import text_decoder_from_numpy
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.inference_pipelines.text import EmbeddingToTextModelPipeline
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs
    from sonar_tpu_torch.parallel import make_mesh, mining

    mesh = make_mesh(1, 1)
    corpus = handoff["corpus"]
    for mode in ("int8", "bf16"):
        pipe = _text_pipeline(torch, handoff, torch.bfloat16, mode == "int8", mesh)
        pipe.predict(corpus[:256], source_lang="eng_Latn", batching="static")  # warm, as (d)
        t0 = time.perf_counter()
        emb, counts = _counted(torch, launches, lambda: pipe.predict(
            corpus, source_lang="eng_Latn", batching="static"))
        text = ("short_qkv_attention", "fused_attn_block", "fused_int8_ffn", "flash_attention")
        same = {n: counts[n] == ref[f"d_launches_{mode}"][n] for n in text}
        checks.add(f"(l1) {mode} encoder, mesh 1 x 1 over NCCL, {len(corpus)} sentences",
                   np.array_equal(emb, ref[f"d_{mode}"]) and all(same.values()),
                   f"embeddings equal to (d)'s bit for bit: {np.array_equal(emb, ref[f'd_{mode}'])}; "
                   f"launches {[counts[n] for n in text]} against (d)'s "
                   f"{[ref[f'd_launches_{mode}'][n] for n in text]}", t0)
        del pipe
    torch.cuda.empty_cache()

    cfg = sonar_text_decoder_archs.get("basic")
    dec = TorchTextDecoder(text_decoder_from_numpy(handoff["decoder_params"], cfg,
                                                   torch.bfloat16, DEVICE),
                           device=DEVICE, mesh=mesh)
    pipe = EmbeddingToTextModelPipeline(dec, handoff["tokenizer"])
    pipe.predict(ref["f_memory"][:32], target_lang="eng_Latn", batch_size=32,
                 **DECODE_KW)  # warm, as (f)
    outs = _recording(dec)
    t0 = time.perf_counter()
    _counted(torch, launches, lambda: pipe.predict(ref["f_memory"], target_lang="eng_Latn",
                                                   batch_size=32, **DECODE_KW))
    same = len(outs) == len(ref["f_beam"]) and all(
        np.array_equal(a, b) for got, want in zip(outs, ref["f_beam"]) for a, b in zip(got, want))
    checks.add(f"(l1) bf16 decoder, mesh 1 x 1, {EMB_TO_TEXT}", same,
               f"tokens, scores and lengths of {len(outs)} beam calls equal to (f)'s: {same}", t0)
    del dec, pipe
    torch.cuda.empty_cache()

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x, y = _planted(torch, gen, MINING_ROWS, MINING_DIM, 2.0)
    want = mining.cosine_topk(x, y, MINING_K, device=DEVICE)  # (i)'s fp32 exact call
    t0 = time.perf_counter()
    got, _ = _counted(torch, launches, lambda: mining.sharded_cosine_topk(
        x, y, MINING_K, mesh, device=DEVICE))
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    checks.add(f"(l1) sharded_cosine_topk fp32 [{MINING_ROWS}, {MINING_DIM}] top {MINING_K}, "
               f"mesh 1 x 1", same, f"scores and indices equal to (i)'s bit for bit: {same}", t0)
    del x, y, got, want
    torch.cuda.empty_cache()

    base_loss, base, paths = _k4_step(torch, handoff, DEVICE)
    t0 = time.perf_counter()
    (loss, grads, _), _ = _counted(torch, launches, lambda: _k4_step(torch, handoff, DEVICE,
                                                                     mesh))
    # The embedding tables' gradients are sums by atomic adds (index_put_
    # with accumulate), whose order varies between two runs of the same
    # step: they are held to (k4)'s limit, every other leaf to the bit.
    err = _grad_errors(paths, grads, base)
    tables = [p for p in paths if p.endswith("embed/weight")]
    same = loss == base_loss == ref["k4_loss"] and all(
        torch.equal(a, b) for p, a, b in zip(paths, grads, base) if p not in tables)
    table_err = max(err[p] for p in tables)
    checks.add("(l1) make_train_step(mesh 1 x 1), (k4)'s model",
               same and table_err <= TRAIN_GRAD_LIMIT,
               f"loss {loss!r} against (k4)'s {ref['k4_loss']!r}; {len(grads) - len(tables)} "
               f"gradient leaves equal to the mesh-free step's bit for bit: {same}; the "
               f"{len(tables)} embedding tables within {table_err:.3e} of their scale "
               f"(<= {TRAIN_GRAD_LIMIT:g})", t0)


def _probe_gloo(torch, mesh):
    """Each collective the port issues, on CUDA tensors of each dtype it sums
    or compares, over the world: gloo must take them all."""
    import torch.distributed as dist

    failures = []
    for dtype in (torch.bfloat16, torch.float32, torch.int32, torch.int64):
        for op in (dist.ReduceOp.SUM, dist.ReduceOp.MAX):
            t = torch.full((4,), mesh.rank + 1, dtype=dtype, device=DEVICE)
            try:
                dist.all_reduce(t, op=op)
                torch.cuda.synchronize()
                want = 3 if op == dist.ReduceOp.SUM else 2
                if not bool((t == want).all()):
                    failures.append(f"all_reduce {op} {dtype}: read {t.tolist()}")
            except RuntimeError as err:
                failures.append(f"all_reduce {op} {dtype}: {err}")
    t = torch.full((4,), float(mesh.rank), device=DEVICE)
    try:
        dist.broadcast(t, src=0)
    except RuntimeError as err:
        failures.append(f"broadcast float32: {err}")
    return failures


def _cos(a, b):
    import numpy as np

    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


class _Swapped:
    """``target.name`` replaced by ``value`` inside the block, restored on
    exit."""

    def __init__(self, target, name, value):
        self.target, self.name, self.value = target, name, value

    def __enter__(self):
        self.saved = getattr(self.target, self.name)
        setattr(self.target, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.target, self.name, self.saved)


def _planted_int8(variant):
    """A wrong row-parallel int8 projection, for (l2)'s controls: the
    readings that the model-2 int8 check must catch. ``"local"`` drops the
    all_reduce of the row absmax (each rank quantizes its slice by the
    slice's own maximum; the int32 sums are summed and scaled by the rank's
    own scale); ``"sliced"`` quantizes and scales each slice alone and sums
    the fp32 products."""
    from sonar_tpu_torch.ops import quantization
    from sonar_tpu_torch.parallel import comm

    if variant == "local":
        return _Swapped(comm, "all_max", lambda x, group: x)
    plain = quantization.int8_linear

    def sliced(params, x, group=None):
        if group is None:
            return plain(params, x)
        y = comm.all_sum(plain({k: params[k] for k in ("kernel_q", "scale")}, x.float()), group)
        return (y + params["bias"].float() if "bias" in params else y).to(x.dtype)

    return _Swapped(quantization, "int8_linear", sliced)


def _split_of_one():
    """The layers' model-split code path on one rank: ``nn.transformer``
    reads a model group of one (the whole-block kernels #2 and #3 off, the
    row-parallel int8 absmax and int32 sums taken over that one rank). In
    int8 it is the function a model-2 split must give to the bit: every
    split product is an exact int32 sum."""
    from sonar_tpu_torch.nn import transformer
    from sonar_tpu_torch.parallel import comm

    return _Swapped(transformer, "model_group", lambda: comm.SINGLE)


def _scaleout_l2(torch, checks, ref, handoff, launches):
    """(l2): two ranks sharing the card over gloo."""
    import numpy as np

    from sonar_tpu_torch.parallel import make_mesh

    world = make_mesh(2, 1)
    t0 = time.perf_counter()
    refused = _probe_gloo(torch, world)
    checks.add("(l2) gloo collectives on CUDA tensors (all_reduce sum / max of bf16, fp32, "
               "int32, int64; broadcast)", not refused, f"refused: {refused or 'none'}", t0)
    if refused:
        return
    corpus = handoff["corpus"]
    long_idx = [i for i, t in enumerate(corpus) if len(t.split()) >= 250][:16]
    idx = [i for i in range(len(corpus)) if i not in long_idx][:SCALEOUT_TEXT - 16] + long_idx
    texts = [corpus[i] for i in idx]
    pipe = _text_pipeline(torch, handoff, torch.bfloat16, True, None)
    with _split_of_one():
        one = pipe.predict(texts, source_lang="eng_Latn", batching="static")
    del pipe
    split = make_mesh(1, 2)
    for mode in ("bf16", "int8"):
        pipe = _text_pipeline(torch, handoff, torch.bfloat16, mode == "int8", split)
        t0 = time.perf_counter()
        emb, counts = _counted(torch, launches, lambda: pipe.predict(
            texts, source_lang="eng_Latn", batching="static"))
        limit = SCALEOUT_COS[mode]

        def reading(emb):
            """-> (whether ``emb`` passes, what it reads)."""
            cos = _cos(emb, ref[f"d_{mode}"][idx])
            ok, text = cos.min() >= limit, (f"min cosine against (d) {cos.min():.6f}, 1 - cos "
                                            f"{1 - cos.min():.3e} (>= {limit})")
            if mode == "int8":
                ok = ok and np.array_equal(emb, one)
                text += (f"; against the split of one rank max-abs "
                         f"{np.abs(emb - one).max():.3e} (bit for bit)")
            return ok, text

        ok, text = reading(emb)
        kernels_ok = (counts["short_qkv_attention"] > 0 and counts["flash_attention"] > 0
                      and counts["fused_attn_block"] == 0 and counts["fused_int8_ffn"] == 0)
        checks.add(f"(l2) {mode} encoder, model 2 (rank {split.model_index}), {len(texts)} "
                   f"sentences", ok and kernels_ok,
                   f"{text}; launches #1 {counts['short_qkv_attention']}, #5 "
                   f"{counts['flash_attention']} (> 0), #2 {counts['fused_attn_block']}, #3 "
                   f"{counts['fused_int8_ffn']} (0)", t0)
        controls = (("local", "the row absmax not agreed over the model group"),
                    ("sliced", "each slice quantized and scaled alone")) if mode == "int8" else ()
        for variant, what in controls:
            t0 = time.perf_counter()
            with _planted_int8(variant):
                bad = pipe.predict(texts, source_lang="eng_Latn", batching="static")
            ok, text = reading(bad)
            checks.add(f"(l2) int8 control, model 2 (rank {split.model_index}): {what}", not ok,
                       f"{text}; the check catches it: {not ok}", t0)
        del pipe
    torch.cuda.empty_cache()

    pipe = _text_pipeline(torch, handoff, torch.bfloat16, True, world)
    t0 = time.perf_counter()
    emb, counts = _counted(torch, launches, lambda: pipe.predict(
        corpus, source_lang="eng_Latn", batching="static"))
    same = np.array_equal(emb, ref["d_int8"])
    checks.add(f"(l2) int8 encoder, data 2 (rank {world.data_index}), {len(corpus)} sentences",
               same and counts["fused_attn_block"] > 0,
               f"embeddings equal to (d)'s bit for bit: {same}; launches #2 "
               f"{counts['fused_attn_block']}, #3 {counts['fused_int8_ffn']}", t0)
    del pipe
    torch.cuda.empty_cache()

    base_loss, base, paths = _k4_step(torch, handoff, DEVICE)
    t0 = time.perf_counter()
    (loss, grads, _), _ = _counted(torch, launches, lambda: _k4_step(torch, handoff, DEVICE,
                                                                     world))
    err = _grad_errors(paths, grads, base)
    loss_err = abs(loss - base_loss) / abs(base_loss)
    worst = sorted(err.items(), key=lambda kv: -kv[1])[:3]
    checks.add("(l2) make_train_step(mesh 2 x 1), (k4)'s model, 2 rows a rank",
               loss_err <= TRAIN_LOSS_LIMIT and max(err.values()) <= TRAIN_GRAD_LIMIT,
               f"loss {loss:.6f} against the single-rank step's {base_loss:.6f} (rel "
               f"{loss_err:.3e} <= {TRAIN_LOSS_LIMIT:g}); worst leaves "
               f"{[(p, f'{e:.3e}') for p, e in worst]} of the scale (<= {TRAIN_GRAD_LIMIT:g})",
               t0)


def scaleout_child(torch, card, name, rank, world):
    """One rank of (l1), (l2) or (m): joins its group, runs its checks and
    prints one JSON line ``{"scaleout": name, "rank", "launches", "checks"}``."""
    import numpy as np

    from sonar_tpu_torch.ops import _build
    from sonar_tpu_torch.parallel import initialize

    _build.build()  # the parent's library: no compile
    initialize(f"file://{SCALEOUT_DIR / f'rendezvous_{name}'}", rank=rank, world_size=world,
               backend="nccl" if name == "l1" else "gloo")
    with np.load(SCALEOUT_DIR / ("ref_m.npz" if name == "m" else "ref.npz")) as f:
        ref = {k: f[k] for k in f.files}
    t0 = time.perf_counter()
    if name == "m":
        handoff = _pipeline_handoff(torch, SCALEOUT_DIR / f"{name}_{rank}")
        run = _scaleout_m
    else:
        config = json.loads((SCALEOUT_DIR / "ref.json").read_text())
        ref.update(config)
        ref["f_beam"] = [tuple(ref[f"f_beam_{i}_{j}"] for j in range(3))
                         for i in range(config["f_calls"])]
        handoff = _scaleout_handoff(torch, SCALEOUT_DIR / f"{name}_{rank}")
        run = _scaleout_l1 if name == "l1" else _scaleout_l2
    log(f"({name[0]}) {name} rank {rank}: tokenizer, corpus and weights drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    checks, launches = _Checks(card), dict.fromkeys(KERNELS, 0)
    run(torch, checks, ref, handoff, launches)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps({"scaleout": name, "rank": rank, "launches": launches,
                      "checks": checks.rows}), flush=True)
    return 0


def _children(specs):
    """Start every rank of each (name, world) of ``specs`` together:
    -> [(name, rank, process)]."""
    return [(name, rank, subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--scaleout-child", name, str(rank),
         str(world)], cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, world in specs for rank in range(world)]


def _collect(children):
    """Each child's ``#`` lines, echoed with its name, and its JSON line;
    raises if one fails, prints none or outlives SCALEOUT_TIMEOUT."""
    results = []
    deadline = time.perf_counter() + SCALEOUT_TIMEOUT
    try:
        for name, rank, p in children:
            try:
                out = p.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0]
            except subprocess.TimeoutExpired:
                raise AssertionError(f"({name[0]}) {name} rank {rank} did not finish in "
                                     f"{SCALEOUT_TIMEOUT} s")
            lines = out.splitlines()
            for line in lines:
                if line.startswith("#"):
                    print(f"# [{name} rank {rank}] {line[2:]}", flush=True)
            rows = [json.loads(x) for x in lines if x.startswith('{"scaleout"')]
            if p.returncode != 0 or not rows:
                tail = "\n".join(x for x in lines[-40:] if not x.startswith("#"))
                raise AssertionError(f"({name[0]}) {name} rank {rank} failed (exit "
                                     f"{p.returncode}):\n{tail}")
            results.append(rows[-1])
    finally:
        for _, _, p in children:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def run_scaleout(torch, card, handoff):
    """Phases (l) and (m) in child processes (the main process never joins a
    process group), all five at once. (l): the mesh runtimes, sharded mining
    and mesh training; (l1) world 1 over NCCL, bit for bit against (d), (f),
    (i) and (k4); (l2) two ranks sharing the card over gloo, model 2 and
    data 2. (m): pipeline and sequence parallelism on two more ranks over
    gloo. Returns the launch counts summed over the children's driven
    runs."""
    import numpy as np

    SCALEOUT_DIR.mkdir(parents=True, exist_ok=True)
    for old in SCALEOUT_DIR.glob("rendezvous_*"):
        old.unlink()
    beam = handoff["beam_outputs"][f"bf16 {EMB_TO_TEXT}"]
    np.savez(SCALEOUT_DIR / "ref.npz", d_int8=handoff["static_embeddings"]["int8"],
             d_bf16=handoff["static_embeddings"]["bf16"], f_memory=handoff["embeddings"],
             **{f"f_beam_{i}_{j}": a for i, out in enumerate(beam) for j, a in enumerate(out)})
    (SCALEOUT_DIR / "ref.json").write_text(json.dumps({
        "k4_loss": handoff["k4_loss"], "f_calls": len(beam),
        **{f"d_launches_{m}": handoff["static_launches"][m] for m in ("int8", "bf16")}}))
    pipeline_refs(handoff)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return _run_children(card, (("l1", 1), ("l2", 2), ("m", 2)), "(l) and (m)")


def _run_children(card, specs, label):
    """Run the ranks of ``specs`` ((name, world) pairs) at once; -> their
    launch counts summed. Raises if a check of any child failed."""
    launches = dict.fromkeys(KERNELS, 0)
    failed = []
    t0 = time.perf_counter()
    for row in _collect(_children(specs)):
        for n in KERNELS:
            launches[n] += row["launches"][n]
        failed += [f"{row['scaleout']} rank {row['rank']}: {c['name']}" for c in row["checks"]
                   if not c["ok"]]
    log(f"{label} {', '.join(f'{name} x {world}' for name, world in specs)} ranks, run at "
        f"once, in {time.perf_counter() - t0:.1f} s, on {card}")
    log(f"{label} launches over the children's driven runs: {launches}")
    if failed:
        raise AssertionError(f"{label} checks failed: {failed}")
    return launches


# -- (m) pipeline and sequence parallelism, in child processes ----------------------

PP_MICROBATCHES = 2  # (m1): m; a microbatch of an 8192-token batch holds 4096 tokens
PP_COS = 0.999  # (m1): cosine per sentence or clip against (d) / (e)
SP_COS, SP_F32_LIMIT = 0.999, 1e-3  # (m2): bf16 cosine per clip; fp32 max-abs x the scale


def _microbatched(torch, stack, m):
    """A ``stack_fn`` that runs ``stack(layers, x, *aux)`` on ``m`` equal row
    chunks in turn: the plain stack microbatch by microbatch, the function
    each pipeline stage runs."""
    def run(layers, x, *aux):
        parts = [[None] * m if a is None else a.chunk(m) for a in aux]
        return torch.cat([stack(layers, xc, *(p[i] for p in parts))
                          for i, xc in enumerate(x.chunk(m))])
    return run


def _fbank_batch(torch, fbank_config, waves, even=False):
    """``TorchSpeechEncoder.encode_waveforms``' features of one batch: the
    rows padded to a power of two, the waves to their bucket; with ``even``
    two zero frames more where the frame count would give an odd S.
    -> (features, frame counts) on the card."""
    import numpy as np

    from sonar_tpu_torch.data.collate import round_up_pow2
    from sonar_tpu_torch.inference_pipelines.speech import _bucket_len
    from sonar_tpu_torch.ops.fbank import batched_fbank, num_frames

    max_t = _bucket_len(max(w.shape[0] for w in waves))
    batch = np.zeros((round_up_pow2(len(waves)), max_t), np.float32)
    lens = np.zeros((batch.shape[0],), np.int32)
    for i, w in enumerate(waves):
        batch[i, :w.shape[0]], lens[i] = w, w.shape[0]
    frames = num_frames(max_t, fbank_config)
    with torch.inference_mode():
        feats, frame_lens = batched_fbank(torch.from_numpy(batch).to(DEVICE),
                                          torch.from_numpy(lens).to(DEVICE), frames,
                                          fbank_config)
    if even and (frames // 2) % 2:
        feats = torch.nn.functional.pad(feats, (0, 0, 0, 2))
    return feats, frame_lens


def _pipeline_handoff(torch, workdir):
    """(m)'s draws: (d)'s tokenizer, corpus and weights, as (l) draws them,
    and (e)'s weights and clips."""
    import numpy as np

    from sonar_tpu_torch.assets.convert import init_speech_encoder_params
    from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs

    handoff = _scaleout_handoff(torch, workdir, decoder=False)
    handoff["speech_params"] = init_speech_encoder_params(
        sonar_speech_encoder_archs.get("english"), seed=0)
    handoff["speech_clips"] = _speech_traffic(np.random.default_rng(0))
    return handoff


def _m1_text(torch, checks, ref, handoff, launches, mesh):
    """(m1), text: the ``basic`` encoder (24 layers, 12 a stage) over (d)'s
    static batches through ``pipeline_text_encode``, int8 and bf16."""
    import numpy as np

    from sonar_tpu_torch.assets.convert import text_encoder_from_numpy
    from sonar_tpu_torch.data.batcher import StaticShapeBatcher
    from sonar_tpu_torch.inference_pipelines.text import TorchTextEncoder, _static_len_buckets_for
    from sonar_tpu_torch.models.sonar_text import sonar_text_encoder_archs
    from sonar_tpu_torch.nn.transformer import encoder_stack
    from sonar_tpu_torch.ops.precision import matmul_precision_for
    from sonar_tpu_torch.parallel import pipeline_shard_params, pipeline_text_encode

    cfg = sonar_text_encoder_archs.get("basic")
    corpus, tokenizer = handoff["corpus"], handoff["tokenizer"]
    want = {"int8": ("fused_attn_block", "fused_int8_ffn"),
            "bf16": ("short_qkv_attention", "flash_attention")}
    for mode in ("int8", "bf16"):
        enc = TorchTextEncoder(text_encoder_from_numpy(handoff["text_params"], cfg,
                                                       torch.bfloat16, DEVICE),
                               fuse_qkv=True, quantize=mode == "int8", device=DEVICE)
        model, tree = enc.model, enc.model.params.tree()
        if mode == "int8":  # (d)'s static batches, as predict(batching="static") makes them
            encode = tokenizer.create_encoder(lang="eng_Latn")
            max_len = model.max_source_len
            batcher = StaticShapeBatcher(pad_value=tokenizer.vocab_info.pad_idx,
                                         len_buckets=_static_len_buckets_for(max_len),
                                         tokens_per_batch=8192)
            batches = [(torch.from_numpy(b.seqs).to(DEVICE), torch.from_numpy(b.seq_lens).to(
                DEVICE), b.true_batch, pos) for b, pos in batcher.batches(
                [list(encode(t))[:max_len] for t in corpus], yield_indices=True)]
        placed = pipeline_shard_params(tree, mesh)
        stack = _microbatched(torch, lambda p, x, b: encoder_stack(
            p, x, b, cfg.num_encoder_attn_heads, cfg.activation_fn, "pre"), PP_MICROBATCHES)

        def run(pipelined):
            out = []
            with torch.inference_mode(), matmul_precision_for(torch.bfloat16):
                for seqs, lens, n, _ in batches:
                    emb = (pipeline_text_encode(model, placed, seqs, lens, mesh=mesh,
                                                num_microbatches=PP_MICROBATCHES)
                           if pipelined else
                           model.forward_with(tree, seqs, lens, stack_fn=stack).sentence_embeddings)
                    out.append(emb[:n])
            return out

        run(True)  # warm: kernels, allocator, the links' first transfers
        t0 = time.perf_counter()
        got, counts = _counted(torch, launches, lambda: run(True))
        pp_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        plain = run(False)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t1
        same = all(torch.equal(a, b) for a, b in zip(got, plain))
        emb = np.zeros((len(corpus), cfg.model_dim), np.float32)
        for (_, _, _, pos), e in zip(batches, got):
            emb[pos] = e.float().cpu().numpy()
        cos = _cos(emb, ref[f"d_{mode}"])
        ok = same and cos.min() >= PP_COS and all(counts[k] > 0 for k in want[mode])
        checks.add(f"(m1) {mode} text encoder, stage 2 (rank {mesh.model_index}), "
                   f"{len(corpus)} sentences in {len(batches)} static batches, m "
                   f"{PP_MICROBATCHES}", ok,
                   f"equal to the single-rank stack run microbatch by microbatch bit for bit: "
                   f"{same}; min cosine against (d) {cos.min():.6f} (>= {PP_COS}), max-abs "
                   f"{np.abs(emb - ref[f'd_{mode}']).max():.3e}; launches "
                   f"{ {k: counts[k] for k in want[mode]} } (> 0); pipelined {pp_s:.2f} s, the "
                   f"single rank microbatched {ref_s:.2f} s", t0)
        del enc, model, tree, placed, got, plain
        torch.cuda.empty_cache()


def _m1_speech(torch, checks, ref, handoff, launches, mesh):
    """(m1), speech: the ``english`` Conformer (24 layers, 12 a stage) in
    bf16 over (e)'s 3-40 s clips (S 299-1999) through
    ``pipeline_speech_encode``, in (e)'s length-sorted batches of 8."""
    from sonar_tpu_torch.assets.convert import speech_encoder_from_numpy
    from sonar_tpu_torch.inference_pipelines.speech import TorchSpeechEncoder
    from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs
    from sonar_tpu_torch.nn.conformer import conformer_stack
    from sonar_tpu_torch.ops.precision import matmul_precision_for
    from sonar_tpu_torch.parallel import pipeline_shard_params, pipeline_speech_encode

    cfg = sonar_speech_encoder_archs.get("english")
    clips = handoff["speech_clips"]
    enc = TorchSpeechEncoder(speech_encoder_from_numpy(handoff["speech_params"], cfg,
                                                       torch.bfloat16, DEVICE), device=DEVICE)
    model, tree = enc.model, enc.model.params.tree()
    placed = pipeline_shard_params(tree, mesh)
    order = sorted((i for i, w in enumerate(clips) if 3 * 16000 <= w.shape[0] <= 40 * 16000),
                   key=lambda i: clips[i].shape[0])
    batches = [order[k:k + 8] for k in range(0, len(order), 8)]
    feats = [_fbank_batch(torch, enc.fbank_config, [clips[i] for i in b]) for b in batches]
    stack = _microbatched(torch, lambda p, x, b, mk: conformer_stack(p, x, b, mk, cfg.conformer),
                          PP_MICROBATCHES)

    def run(pipelined):
        out = []
        with torch.inference_mode(), matmul_precision_for(torch.bfloat16):
            for b, (f, n) in zip(batches, feats):
                res = (pipeline_speech_encode(model, placed, f, n, mesh=mesh,
                                              num_microbatches=PP_MICROBATCHES)
                       if pipelined else model.forward_with(tree, f, n, stack_fn=stack))
                out.append(res.sentence_embeddings[:len(b)])
        return out

    run(True)
    t0 = time.perf_counter()
    got, counts = _counted(torch, launches, lambda: run(True))
    pp_s = time.perf_counter() - t0
    plain = run(False)
    same = all(torch.equal(a, b) for a, b in zip(got, plain))
    emb = torch.cat(got).float().cpu().numpy()
    cos = _cos(emb, ref["e_bf16"][[i for b in batches for i in b]])
    s_max = max(int(f.shape[1]) // 2 for f, _ in feats)
    ok = same and cos.min() >= PP_COS and counts["relpos_flash_attention_v2"] > 0
    checks.add(f"(m1) bf16 speech encoder, stage 2 (rank {mesh.model_index}), {len(order)} clips "
               f"in {len(batches)} batches of 8, S up to {s_max}, m {PP_MICROBATCHES}", ok,
               f"equal to the single-rank stack run microbatch by microbatch bit for bit: {same}; "
               f"min cosine against (e) {cos.min():.6f} (>= {PP_COS}); launches #6 "
               f"{counts['relpos_flash_attention_v2']} (> 0); pipelined {pp_s:.2f} s", t0)


def _m2(torch, checks, ref, handoff, launches, mesh):
    """(m2): the ``english`` Conformer with its frames split over ``seq`` 2,
    bf16 and fp32, on one batch of (e)'s clips: two of 45-50 s (S 2499,
    padded to 2500) and two of 25-40 s, against the single-rank encode of
    the same batch (which takes the plain rel-pos path too: S > 2048)."""
    import numpy as np

    from sonar_tpu_torch.assets.convert import speech_encoder_from_numpy
    from sonar_tpu_torch.inference_pipelines.speech import TorchSpeechEncoder
    from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs
    from sonar_tpu_torch.nn import conformer
    from sonar_tpu_torch.ops.precision import matmul_precision_for
    from sonar_tpu_torch.parallel import sequence_speech_encode

    cfg = sonar_speech_encoder_archs.get("english")
    clips = handoff["speech_clips"]
    longest = [i for i, w in enumerate(clips) if w.shape[0] >= 45 * 16000][:2]
    middle = [i for i, w in enumerate(clips) if 25 * 16000 <= w.shape[0] <= 40 * 16000][:2]
    waves = [clips[i] for i in longest + middle]
    for mode, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        enc = TorchSpeechEncoder(speech_encoder_from_numpy(handoff["speech_params"], cfg, dtype,
                                                           DEVICE), device=DEVICE)
        model, tree = enc.model, enc.model.params.tree()
        feats, frame_lens = _fbank_batch(torch, enc.fbank_config, waves, even=True)
        s = feats.shape[1] // 2
        with torch.inference_mode(), matmul_precision_for(dtype):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            one = model.forward_with(tree, feats, frame_lens).sentence_embeddings.float()
            torch.cuda.synchronize()
            one_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            conformer.PLAIN_CALLS = 0
            t0 = time.perf_counter()
            got, counts = _counted(torch, launches, lambda: sequence_speech_encode(
                model, tree, feats, frame_lens, mesh=mesh).sentence_embeddings.float())
            sp_s = time.perf_counter() - t0
            sp_peak, plain = torch.cuda.max_memory_allocated(), conformer.PLAIN_CALLS
        got, one = got[:len(waves)].cpu().numpy(), one[:len(waves)].cpu().numpy()
        cos, err = _cos(got, one), float(np.abs(got - one).max())
        scale = float(np.abs(one).max())
        ok = (np.isfinite(got).all() and plain > 0
              and (cos.min() >= SP_COS if mode == "bf16" else err <= SP_F32_LIMIT * scale))
        checks.add(f"(m2) {mode} speech encoder, seq 2 (rank {mesh.model_index}), "
                   f"{len(waves)} clips at S {s} ({s // 2} frames a rank)", ok,
                   f"against the single-rank encode: min cosine {cos.min():.6f}, max-abs "
                   f"{err:.3e} of the scale {scale:.3g} ({'cos >= ' + str(SP_COS) if mode == 'bf16' else f'<= {SP_F32_LIMIT:g} x the scale'}); "
                   f"plain rel-pos calls {plain}, launches {sum(counts.values())}; peak device "
                   f"memory {(sp_peak - base) / 2**30:.3f} GiB over the {base / 2**30:.3f} GiB "
                   f"held before, against the single rank's {(one_peak - base) / 2**30:.3f} GiB; "
                   f"{sp_s:.2f} s", t0)
        del enc, model, tree, feats
        torch.cuda.empty_cache()


def _m3(torch, checks, ref, handoff, launches, stages, seqs):
    """(m3): one fp32 backward each of ``pipeline_text_encode`` (stage 2) and
    ``sequence_speech_encode`` (seq 2) on (k4)'s cut models (2 layers, full
    width) against the single-rank backward of the same loss (the sum of the
    squared embeddings); every leaf the rank holds within (k4)'s limit of
    its scale."""
    import dataclasses

    from sonar_tpu_torch.models.sonar_speech import SonarSpeechEncoder, sonar_speech_encoder_archs
    from sonar_tpu_torch.models.sonar_text import SonarTextEncoder, sonar_text_encoder_archs
    from sonar_tpu_torch.nn.core import tree_leaves
    from sonar_tpu_torch.ops.fbank import FbankConfig
    from sonar_tpu_torch.ops.precision import matmul_precision_for
    from sonar_tpu_torch.parallel import pipeline_text_encode, sequence_speech_encode

    def grads(tree, loss_fn):
        leaves = tree_leaves(tree)
        for leaf in leaves:
            leaf.grad = None
            leaf.requires_grad_(True)
        with matmul_precision_for(torch.float32):
            loss = loss_fn()
            loss.backward()
        return float(loss), [leaf.grad.detach().clone().cpu() for leaf in leaves]

    tcfg = dataclasses.replace(sonar_text_encoder_archs.get("basic"), num_encoder_layers=2)
    tree = _card_tree(torch, _first_layers(handoff["text_params"], 2))
    text = SonarTextEncoder(tcfg, tree)
    batch = _translation_batch(torch, handoff, K4_ROWS, DEVICE)
    src, lens = batch["src_tokens"], batch["src_lens"]
    scfg = sonar_speech_encoder_archs.get("english")
    scfg = dataclasses.replace(scfg, conformer=dataclasses.replace(scfg.conformer, num_layers=2))
    stree = _card_tree(torch, _first_layers(handoff["speech_params"], 2))
    speech = SonarSpeechEncoder(scfg, stree)

    waves = [w for w in handoff["speech_clips"] if 5 * 16000 <= w.shape[0] <= 10 * 16000][:2]
    feats, frame_lens = _fbank_batch(
        torch, FbankConfig(num_mel_bins=scfg.frontend.num_fbank_channels), waves, even=True)
    cases = (
        ("text", stages, tree, lambda: (pipeline_text_encode(
            text, tree, src, lens, mesh=stages) ** 2).sum(),
         lambda: (text.forward_with(tree, src, lens).sentence_embeddings ** 2).sum()),
        ("speech", seqs, stree, lambda: (sequence_speech_encode(
            speech, stree, feats, frame_lens, mesh=seqs).sentence_embeddings ** 2).sum(),
         lambda: (speech.forward_with(stree, feats, frame_lens).sentence_embeddings ** 2).sum()),
    )
    for name, mesh, params, split, whole in cases:
        t0 = time.perf_counter()
        (loss, got), counts = _counted(torch, launches, lambda: grads(params, split))
        base_loss, want = grads(params, whole)
        paths = _leaf_paths(params)
        if name == "text":  # the rank holds its stage's layer of each stacked leaf
            def held(t, p):
                return t[mesh.model_index:mesh.model_index + 1] if "/layers/" in p else t
            got = [held(g, p) for g, p in zip(got, paths)]
            want = [held(w, p) for w, p in zip(want, paths)]
        # No ZERO_GRAD leaf here: the speech pooler's cross-attention reads
        # every frame, so its q and k projections take real gradients.
        err = _grad_errors(paths, got, want, zero=())
        worst = sorted(err.items(), key=lambda kv: -kv[1])[:3]
        loss_err = abs(loss - base_loss) / abs(base_loss)
        ok = max(err.values()) <= TRAIN_GRAD_LIMIT and loss_err <= TRAIN_LOSS_LIMIT and not any(
            counts.values())
        checks.add(f"(m3) fp32 backward of {name} encode, "
                   f"{'stage' if name == 'text' else 'seq'} 2 (rank {mesh.model_index}), 2 "
                   f"layers at full width", ok,
                   f"loss {loss:.6f} against the single rank's {base_loss:.6f} (rel "
                   f"{loss_err:.3e} <= {TRAIN_LOSS_LIMIT:g}); {len(paths)} leaves, worst "
                   f"{[(p, f'{e:.3e}') for p, e in worst]} of the scale (<= "
                   f"{TRAIN_GRAD_LIMIT:g}); launches {sum(counts.values())} (0: autograd "
                   f"records)", t0)
    del tree, stree, text, speech
    torch.cuda.empty_cache()


def _scaleout_m(torch, checks, ref, handoff, launches):
    """(m): two ranks sharing the card over gloo; the (data 1, stage 2) and
    (data 1, seq 2) meshes made in that order on both."""
    from sonar_tpu_torch.parallel import make_pipeline_mesh, make_seq_mesh

    stages, seqs = make_pipeline_mesh(2, 1), make_seq_mesh(2, 1)
    for label, part in (("(m1) text", lambda: _m1_text(torch, checks, ref, handoff, launches,
                                                        stages)),
                        ("(m1) speech", lambda: _m1_speech(torch, checks, ref, handoff,
                                                           launches, stages)),
                        ("(m2)", lambda: _m2(torch, checks, ref, handoff, launches, seqs)),
                        ("(m3)", lambda: _m3(torch, checks, ref, handoff, launches, stages,
                                             seqs))):
        t0 = time.perf_counter()
        part()
        torch.cuda.empty_cache()
        log(f"(m) part {label} took {time.perf_counter() - t0:.1f} s")


def pipeline_refs(handoff):
    """What (m)'s children read: (d)'s static embeddings and (e)'s bf16 ones
    (``ref_m.npz``)."""
    import numpy as np

    SCALEOUT_DIR.mkdir(parents=True, exist_ok=True)
    np.savez(SCALEOUT_DIR / "ref_m.npz", d_int8=handoff["static_embeddings"]["int8"],
             d_bf16=handoff["static_embeddings"]["bf16"],
             e_bf16=handoff["speech_embeddings"]["bf16"])


# -- (n) each path with its kernels off ---------------------------------------------------


OFF_TEXT_BATCHES = 5  # (n): batches timed each way on a text path
OFF_SPEECH_BATCHES = 2  # (n): batches timed each way on the speech path
OFF_DECODES = 2  # (n): decodes timed each way on a decode path
OFF_COS = 0.999  # (n): cosine per sentence or clip, kernels on against off (int8, bf16)
OFF_KEY_ON, OFF_KEY_OFF = (False, "auto", "auto"), (True, "auto", "auto")  # the graphs' settings
# (n): a spin of ~0.4 s before the timed batches, longer than the host takes
# to queue them all (a whole model's launches a batch, eager int8 the most).
OFF_SPIN = 800_000_000


def _replays_first(dec, fn, first):
    """(n)'s graph-cache check, after a decode outside ``no_cuda_kernels()``
    and one inside it on a fresh runtime: two captures, keyed on the scope;
    a third decode outside replays the first's graph (the same object, no
    eager steps before a capture) and equals it bit for bit."""
    import numpy as np

    graphs = list(dec._graphs.items())
    if [key[-1] for key, _ in graphs] != [OFF_KEY_ON, OFF_KEY_OFF]:
        raise AssertionError(f"(n): captures keyed {[key[-1] for key, _ in graphs]}, not one "
                             f"outside the scope and one inside it")
    (key, graph), warm = graphs[0], dec.device_steps - dec.decode_steps
    third = fn()
    replayed = (len(dec._graphs) == 2 and dec._graphs.get(key) is graph
                and dec.device_steps - dec.decode_steps == warm)
    same = all(np.array_equal(a, b) for a, b in zip(third, first))
    if not (replayed and same):
        raise AssertionError(f"(n): the third decode did not replay the first's capture "
                             f"(replayed {replayed}, equal {same})")
    return "2 captures (outside, inside); the third decode replayed the first's, bit for bit"


def _decode_ms(torch, dec, fn, n):
    """Device ms a decode step: CUDA events around ``n`` decodes (each waits
    for its outputs), over the decode steps they took."""
    fn()
    steps = dec.decode_steps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (dec.decode_steps - steps)


def run_kernels_off(torch, card, handoff):
    """(n): each full-width path once with its kernels (the default, or a
    setter's choice) and once inside ``no_cuda_kernels()``, on the models
    and weights of (d)-(h2): the outputs within PERF.md's agreement limits,
    the path's kernels launched without the scope and no kernel inside it
    (captures included), and the device ms of each."""
    import numpy as np

    from sonar_tpu_torch.assets.convert import text_encoder_from_numpy
    from sonar_tpu_torch.generation.beam_search import BeamSearchConfig
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.generation.sampling import TopKSampler
    from sonar_tpu_torch.inference_pipelines.text import TorchTextEncoder
    from sonar_tpu_torch.models.sonar_text import sonar_text_encoder_archs
    from sonar_tpu_torch.ops.gates import kernel_settings, no_cuda_kernels, set_attention_impl

    if kernel_settings() != OFF_KEY_ON:
        raise AssertionError(f"(n) starts under settings {kernel_settings()}")
    rng = np.random.default_rng(0)
    cfg = sonar_text_encoder_archs.get("basic")
    text, decoders = handoff["text_pipelines"], handoff["decoders"]
    prefix = list(handoff["tokenizer"].create_encoder(lang="eng_Latn",
                                                      mode="target").prefix_indices)
    memory = handoff["embeddings"][:32, None, :]
    results = {}

    def cos_rows(on, off):
        on, off = (np.asarray(x.float().cpu() if hasattr(x, "cpu") else x, np.float64)
                   for x in (on, off))
        cos = (on * off).sum(1) / (np.linalg.norm(on, axis=1) * np.linalg.norm(off, axis=1))
        if not (np.isfinite(on).all() and np.isfinite(off).all() and cos.min() >= OFF_COS):
            raise AssertionError(f"min cosine {cos.min():.6f} < {OFF_COS} or not finite")
        return f"min cosine per row {cos.min():.6f} (>= {OFF_COS})"

    def same_tokens(on, off):
        if not (np.array_equal(on[0], off[0]) and np.array_equal(on[2], off[2])):
            raise AssertionError("the sampled tokens differ")
        gap = float(np.abs(on[1] - off[1]).max())
        return f"tokens and lengths identical, scores {gap:.3e} apart"

    def same_best(on, off):
        _same_best("(n) fp32 beam, kernels on against off", on, off)
        gap = float(np.abs(on[1][:, 0] - off[1][:, 0]).max())
        return f"best hypotheses agree, best scores {gap:.3e} apart"

    def path(label, unit, run, kernels, agree, ms, impl="auto", absent=(), after=None):
        t0 = time.perf_counter()
        set_attention_impl(impl)
        try:
            zero_launches()
            on = run()
            torch.cuda.synchronize()
            on_counts = read_launches()
            zero_launches()
            with no_cuda_kernels():
                off = run()
            torch.cuda.synchronize()
            off_counts = read_launches()
            missing = [k for k in kernels if on_counts[k] == 0]
            present = [k for k in absent if on_counts[k] != 0]
            leaked = {k: n for k, n in off_counts.items() if n}
            if missing or present or leaked:
                raise AssertionError(f"(n) {label}: kernels on missed {missing}, launched "
                                     f"{present}; inside the scope launched {leaked}")
            detail = agree(on, off)
            if after is not None:
                detail += "; " + after(on)
            ms_on = ms()
            with no_cuda_kernels():
                ms_off = ms()
        finally:
            set_attention_impl("auto")
        launched = {k: n for k, n in on_counts.items() if n}
        results[label] = (ms_on, ms_off)
        log(f"(n) {label}: kernels on {ms_on:.3f}, off {ms_off:.3f} device ms {unit} "
            f"(off / on {ms_off / ms_on:.3f}); launches on {launched}, inside the scope 0; "
            f"{detail} ok ({time.perf_counter() - t0:.1f} s); on {card}")

    def text_path(label, enc, b, s, kernels, **kw):
        seqs = rng.integers(4, cfg.vocab_info.size, (b, s)).astype(np.int32)
        lens = rng.integers(s // 2, s + 1, b).astype(np.int32)
        lens[0] = s
        for i, n in enumerate(lens):
            seqs[i, n:] = 1
        path(f"{label} [{b}, {s}]", "a batch", lambda: enc._encode(seqs, lens), kernels, cos_rows,
             lambda: _timed(torch, lambda: enc._encode(seqs, lens), OFF_TEXT_BATCHES, OFF_SPIN),
             **kw)

    int8, bf16 = text["int8"].model, text["bf16"].model
    text_path("int8 text", int8, 64, 128, ("fused_attn_block", "fused_int8_ffn"))
    text_path("int8 text", int8, 16, 512, ("fused_attn_block", "flash_attention", "fused_int8_ffn"))
    text_path("bf16 text", bf16, 8, 128, ("short_qkv_attention",))
    text_path('int8 text, set_attention_impl("plain")', int8, 16, 512, ("fused_int8_ffn",),
              impl="plain", absent=("flash_attention", "fused_attn_block"))
    unfused = TorchTextEncoder(text_encoder_from_numpy(handoff["text_params"], cfg,
                                                       torch.bfloat16, DEVICE),
                               fuse_qkv=False, quantize=True)
    text_path("int8 text, q/k/v unfused", unfused, 16, 512, ("flash_attention", "fused_int8_ffn"),
              absent=("fused_attn_block",))
    del unfused
    torch.cuda.empty_cache()
    unfused = TorchTextEncoder(text_encoder_from_numpy(handoff["text_params"], cfg,
                                                       torch.bfloat16, DEVICE), fuse_qkv=False)
    text_path('bf16 text, q/k/v unfused, set_attention_impl("cuda")', unfused, 64, 64,
              ("flash_attention",), impl="cuda")
    del unfused
    torch.cuda.empty_cache()

    speech = handoff["speech_pipelines"]["bf16"].model
    waves = [_clip(rng, 20.0) for _ in range(8)]  # S 999
    path("bf16 speech [8 clips of 20 s, S 999]", "a batch",
         lambda: speech.encode_waveforms(waves), ("relpos_flash_attention_v2",), cos_rows,
         lambda: _timed(torch, lambda: speech.encode_waveforms(waves, materialize=False),
                        OFF_SPEECH_BATCHES, OFF_SPIN))

    # The decodes on fresh runtimes over (f)'s fp32 model: their captures
    # are the only ones, so the cache check counts them exactly.
    beam_cfg = BeamSearchConfig(**DECODE_KW)
    for label, kernels, agree, decode in (
            ("fp32 beam decode, graph path [32 embeddings, beam 5, max_gen_len 48]",
             ("beam_masked_attend",), same_best,
             lambda dec: dec.generate_beam(memory, prefix, beam_cfg)),
            ("fp32 top-k 10 sampling, graph path [32 embeddings, max_gen_len 48, seed 7]",
             ("gumbel_max",), same_tokens,
             lambda dec: dec.generate_sample(memory, prefix, TopKSampler(10), SAMPLE_GEN_LEN,
                                             seed=7))):
        dec = TorchTextDecoder(decoders["fp32"].model)
        fn = functools.partial(decode, dec)
        path(label, "a decode step", fn, kernels, agree,
             lambda: _decode_ms(torch, dec, fn, OFF_DECODES),
             after=lambda first: _replays_first(dec, fn, first))
        del dec, fn
        torch.cuda.empty_cache()
    return results


# -- --compare: this checkout against others, in turns, on one card ------------------


def times_of(torch, card, root: Path) -> dict:
    """The port under ``root``: device ms of ``beam_masked_attend`` (bf16,
    K 5, H 16, Dh 64) at the decode shape of (f) and (g) for batches of 32,
    8 and 1 and at S 259, idx 200 with a random and a tree ancestry (warm,
    and with a cold L2 there), with the host's us a call (100 calls queued
    back to back), and in fp32 at B 32; of ``beam_diag_attend`` (bf16) at
    B 32, 8 and 1 and at S 259, idx 200 (warm, and with a cold L2 at B 32),
    and in fp32 at B 32; of ``beam_reorder_attend`` (bf16) at B 32, S 51 with a random and
    a one-row sel and at S 259, idx 200, warm and cold; of rel-pos v1 at
    [8, 16, 499, 64] in bf16 and fp32 and v2 there in fp32; of
    ``fused_bf16_ffn_ln_residual`` at M 3992, D 1024, F 4096, 2 splits; and
    the ms a step of the full-width ``basic`` decoder in bf16 (beam 5,
    max_gen_len 48) decoding batches of 8 (the batch of (g) and of
    text->text in (f)) and 1 (one sentence), 3 runs each."""
    sys.path.insert(0, str(root))
    import numpy as np

    from sonar_tpu_torch.assets.convert import init_text_decoder_params, text_decoder_from_numpy
    from sonar_tpu_torch.generation.beam_search import BeamSearchConfig
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs
    from sonar_tpu_torch.nn.conformer import _trig_tables
    from sonar_tpu_torch.ops import _build
    from sonar_tpu_torch.ops.cuda import beam_attend, ffn, relpos_flash

    if not Path(_build.__file__).resolve().is_relative_to(root):
        raise AssertionError(f"{_build.__file__} is not under {root}")
    t0 = time.perf_counter()
    _build.library()
    log(f"{root}: kernels built in {time.perf_counter() - t0:.1f} s; on {card}")
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"root": str(root), "card": card}
    beam, h, dh = 5, 16, 64
    for b, s, idx, kind in ((32, 51, 25, "random"), (8, 51, 25, "random"), (1, 51, 25, "random"),
                            (32, 259, 200, "random"), (32, 259, 200, "tree")):
        q = torch.randn(b * h, beam, dh, generator=gen, device=dev).bfloat16()
        kc, vc = (torch.randn(b * h, beam, s, dh, generator=gen, device=dev).bfloat16()
                  for _ in range(2))
        anc = (tree_ancestry(torch, b, beam, s, idx, gen, dev) if kind == "tree" else
               torch.randint(0, beam, (b, beam, s), generator=gen, device=dev, dtype=torch.int32))
        vbias = torch.where(torch.arange(s, device=dev) <= idx, 0.0, -1e30).float()
        fn = lambda: beam_attend.beam_masked_attend(q, kc, vc, anc, vbias, h)  # noqa: E731
        n_rows = distinct_rows(torch, anc, idx, beam) * h
        bound_ms = bound(2 * nbytes(q) + nbytes(anc, vbias) + 2 * n_rows * dh * 2, {})[0]
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        host_us = (time.perf_counter() - t0) * 1e4
        torch.cuda.synchronize()
        key = f"beam_masked_attend B {b} S {s} idx {idx} {kind}"
        out[key] = {"ms": _timed(torch, fn, 20), "bound_ms": bound_ms, "host_us": host_us}
        if s > 64:
            out[key]["cold_ms"] = _timed_cold(torch, fn, 20)
        log(f"{root.name}: {key}: {out[key]}")
        del q, kc, vc

    def rnd(*shape, dt=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dt)

    def timed(key, fn, cold=False):
        out[key] = {"ms": _timed(torch, fn, 20)}
        if cold:
            out[key]["cold_ms"] = _timed_cold(torch, fn, 20)
        log(f"{root.name}: {key}: {out[key]}")

    for b, s, idx, dt in ((32, 51, 25, torch.bfloat16), (8, 51, 25, torch.bfloat16),
                          (1, 51, 25, torch.bfloat16), (32, 259, 200, torch.bfloat16),
                          (32, 51, 25, torch.float32)):
        pos = torch.arange(s, device=dev)
        vbias = torch.where(pos <= idx, 0.0, -1e30).float()
        q, k, v = rnd(b, beam, h, dh, dt=dt), rnd(b, h, beam, s, dh, dt=dt), rnd(b, h, beam, s, dh, dt=dt)
        timed(f"beam_diag_attend B {b} S {s} idx {idx}" + (" fp32" if dt == torch.float32 else ""),
              lambda: beam_attend.beam_diag_attend(q, k, v, vbias), cold=s > 64 or b == 32)
    b, s, idx = 32, 51, 25
    pos = torch.arange(s, device=dev)
    vbias = torch.where(pos <= idx, 0.0, -1e30).float()
    q32 = rnd(b * h, beam, dh, dt=torch.float32)
    kc, vc = (rnd(b * h, beam, s, dh, dt=torch.float32) for _ in range(2))
    anc = torch.randint(0, beam, (b, beam, s), generator=gen, device=dev, dtype=torch.int32)
    timed(f"beam_masked_attend fp32 B {b} S {s} idx {idx} random",
          lambda: beam_attend.beam_masked_attend(q32, kc, vc, anc, vbias, h))
    for s, idx, kind in ((51, 25, "random"), (51, 25, "one-row"), (259, 200, "random")):
        pos = torch.arange(s, device=dev)
        sel = torch.randint(0, beam, (b, beam), generator=gen, device=dev, dtype=torch.int32)
        if kind == "one-row":
            sel = sel[:, :1].expand(b, beam).contiguous()
        rargs = (rnd(b, beam, h, dh), rnd(b, beam, h, dh), rnd(b, beam, h, dh),
                 rnd(b, h, beam, s, dh), rnd(b, h, beam, s, dh), sel,
                 torch.where(pos <= idx, 0.0, -1e30).float(), (pos == idx).float())
        timed(f"beam_reorder_attend B {b} S {s} idx {idx} {kind}",
              lambda: beam_attend.beam_reorder_attend(*rargs), cold=True)
    del q, k, v, q32, kc, vc, rargs
    b, s, d = 8, 499, 1024
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (rnd(b, h, s, dh, dt=dt) for _ in range(3))
        wr = rnd(h, d, dh, dt=dt, scale=d ** -0.5)
        u, vb = rnd(h, dh, dt=dt, scale=0.1), rnd(h, dh, dt=dt, scale=0.1)
        si, ci, basis = _trig_tables(s, d, dt, dev)
        kb = torch.zeros(b, s, device=dev)
        bd = relpos_flash.relpos_bd_plain(q, wr, si, ci, basis, vb).to(dt)
        name = str(dt)[6:]
        timed(f"relpos_flash_attention [{b},{h},{s},{dh}] {name}",
              lambda: relpos_flash.relpos_flash_attention(q, k, v, bd, u, kb))
        if dt == torch.float32:
            timed(f"relpos_flash_attention_v2 [{b},{h},{s},{dh}] D {d} {name}",
                  lambda: relpos_flash.relpos_flash_attention_v2(q, k, v, wr, si, ci, basis, u,
                                                                 vb, kb))
        del q, k, v, wr, bd
    m, d, f = 3992, 1024, 4096
    fargs = (torch.randn(m, d, generator=gen, device=dev).bfloat16(),
             torch.ones(d, device=dev), torch.zeros(d, device=dev),
             (torch.randn(d, f, generator=gen, device=dev) * d ** -0.5).bfloat16(),
             torch.zeros(f, device=dev),
             (torch.randn(f, d, generator=gen, device=dev) * f ** -0.5).bfloat16(),
             torch.zeros(d, device=dev), 0.5)
    key = f"fused_bf16_ffn_ln_residual M {m} D {d} F {f} splits 2"
    out[key] = {"ms": _timed(torch, lambda: ffn.fused_bf16_ffn_ln_residual(*fargs, n_splits=2),
                             20)}
    log(f"{root.name}: {key}: {out[key]}")
    del fargs
    cfg = sonar_text_decoder_archs.get("basic")
    dec = TorchTextDecoder(text_decoder_from_numpy(init_text_decoder_params(cfg, seed=0), cfg,
                                                   torch.bfloat16, DEVICE), device=DEVICE)
    gen_cfg = BeamSearchConfig(**DECODE_KW)
    rng = np.random.default_rng(0)
    dec.generate_beam(np.zeros((8, 1, cfg.model_dim), np.float32), [3, 5], gen_cfg)  # warm
    for b in (8, 1):
        memory = rng.standard_normal((b, 1, cfg.model_dim)).astype(np.float32) * 0.1
        runs = []
        for _ in range(3):
            dec.decode_steps = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dec.generate_beam(memory, [3, 5], gen_cfg)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3 / dec.decode_steps)
        out[f"decode bf16 batch {b} ms a step"] = runs
        log(f"{root.name}: decode bf16 batch {b}, {dec.decode_steps} steps: ms a step {runs}")
    return out


def compare(roots) -> int:
    """Run ``times_of`` for each root and this checkout in turns (roots,
    this, this, roots reversed), each in a process of its own; print every
    run's numbers and, last, one JSON object of them."""
    here = REPO.resolve()
    order = [*roots, here, here, *reversed(roots)]
    runs = []
    for root in order:
        proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--times-of",
                               str(root)], capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            log(f"--times-of {root} failed with exit code {proc.returncode}")
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(json.dumps({"compare": runs}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", nargs="+", type=Path, metavar="DIR",
                    help="instead of the phases, time two kernels and beam decoding for the "
                         "checkouts DIR (e.g. an unpacked parent commit) and this one in turns")
    ap.add_argument("--times-of", type=Path, metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--scaleout-child", nargs=3, metavar=("NAME", "RANK", "WORLD"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    torch, card = setup()
    if args.scaleout_child:
        name, rank, world = args.scaleout_child
        return scaleout_child(torch, card, name, int(rank), int(world))
    if args.compare:
        return compare([d.resolve() for d in args.compare])
    if args.times_of:
        print(json.dumps(times_of(torch, card, args.times_of.resolve())), flush=True)
        return 0
    clock = time.perf_counter()

    def phase(label, fn, *args):
        out = fn(*args)
        log(f"phase {label} done at {time.perf_counter() - clock:.1f} s")
        return out

    phase("(b)", build)
    results = phase("(c)", check_kernels, torch)
    text, _, handoff = phase("(d)", run_slice, torch, card)
    speech = phase("(e)", run_speech, torch, card, handoff)
    decode = phase("(f)", run_decode, torch, card, handoff)
    graphs = phase("(f2)", run_graph_vs_eager, torch, card, handoff)
    s2t = phase("(g)", run_speech_to_text, torch, card, handoff)
    rest = phase("(h)", run_sampling_int8_heads, torch, card, handoff)
    sampled = phase("(h2)", run_sample_graph, torch, card, handoff)
    mined = phase("(i)", run_mining, torch, card)
    served = phase("(j)", run_serving, torch, card, handoff)
    trained = phase("(k)", run_training, torch, card, handoff)
    scaled = phase("(l) and (m)", run_scaleout, torch, card, handoff)
    phase("(n)", run_kernels_off, torch, card, handoff)
    launches = {name: sum(run[name] for run in (text, speech, decode, graphs, s2t, rest, sampled,
                                                 mined, served, trained, scaled))
                for name in KERNELS}
    launched = [name for name in NO_PATH if launches[name] != 0]
    if launched:
        raise AssertionError(f"kernels that no path calls were launched: {launched}")
    record = [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
         **{key: results[name][key]
            for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")}}
        for name, (src, tpu, _, _) in KERNELS.items()
    ]
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
