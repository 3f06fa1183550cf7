"""Plain reference of the SONAR speech encoder (arch ``english``), fp32.

Written from the published description (SONAR's ``sonar_speech_encoder_eng``
card: fairseq2's w2v-BERT 2.0 ``600m`` Conformer with SONAR's attention
pooler), one clip at a time, with no padding and no batching:

- Kaldi fbank (``torchaudio.compliance.kaldi.fbank`` as fairseq2's
  ``WaveformToFbankConverter`` calls it): the waveform x 2^15, snip-edges
  frames of 25 ms every 10 ms, each frame's mean removed, pre-emphasis 0.97
  (the first sample against itself), the povey window, the power spectrum of
  a 512-point FFT, 80 triangular mel filters spaced evenly in mel
  (1127 ln(1 + f / 700)) from 20 Hz to Nyquist, log(max(x, FLT_EPSILON)),
  then each bin standardised over the clip's frames (unbiased std). Framing,
  window, filters and the log are computed here in float64.
- The w2v-BERT frontend: pairs of frames stacked into 160-d (an odd last
  frame dropped), LayerNorm, a projection to D.
- Each Conformer block as published: x + 1/2 FFN1 (SiLU), x + relative
  multi-head self-attention, x + the convolution module, x + 1/2 FFN2, a
  LayerNorm, every sub-block pre-LN. The attention is Transformer-XL's:
  score(i, j) = ((q_i + u) . k_j + (q_i + v) . r_(i-j)) / sqrt(Dh), where r
  is the [2S - 1, D] sinusoidal table of distances S - 1 .. -(S - 1) (sin
  on even, cos on odd columns, frequencies exp(-2i ln(10000) / D)) times
  the unbiased ``r_proj``, and the [S, 2S - 1] product (q + v) r^T is put
  in place by the rel-shift (pad a zero column, view as [2S, S], drop the
  first row, view back, keep S columns). The convolution module: pointwise
  D -> 2D, GLU, a depthwise convolution over K frames with zero padding
  (K - 1) / 2 on each side, inference BatchNorm (eps 1e-5), SiLU,
  pointwise D -> D (both pointwise unbiased).
- The final LayerNorm, then the pooler: the BOS row (index 2) of the D-row
  table x sqrt(D) plus the fairseq sinusoidal position table (half sin,
  half cos, frequencies exp(-i ln(10000) / (D/2 - 1))), through 3 post-LN
  Transformer decoder layers (LN(x + self-attention), LN(x + attention over
  the clip's encoded frames), LN(x + ReLU FFN)), then the unbiased
  ``projection_out``.

Departures from fairseq2: the pooler's BOS is read at position row 0 (no
legacy pad offset), as the SONAR port's pooler reads it; no dropout
(inference); the LayerNorms' eps is 1e-5 throughout.

``quant``: ``"bf16"`` (the configuration's precision: the reference runs it
in fp32) or None compute in fp32; ``"fp8"`` (the control) rounds every
linear's input per row and weight per output channel to float8 e4m3, as
``text_encoder.linear`` does.

Plain PyTorch: fp32 with TF32 off, layer by layer over the clips (a layer's
weights made fp32 once). It is given the benchmark's weight tree and the
waveforms, and imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

from perfbench.reference.text_encoder import _fp8, _fp32, attention, layer_norm, precise, sinusoidal
import torch

FLT_EPSILON = 1.1920928955078125e-07
SAMPLE_RATE = 16000
WINDOW, SHIFT, FFT = 400, 160, 512  # 25 ms and 10 ms at 16 kHz; the FFT's points


def _mel(f):
    return 1127.0 * torch.log(1.0 + f / 700.0)


def mel_filters(bins: int, device: Any) -> torch.Tensor:
    """[bins, FFT / 2 + 1] float64 triangles (Kaldi's MelBanks)."""
    lo, hi = _mel(torch.tensor(20.0, dtype=torch.float64)), _mel(
        torch.tensor(SAMPLE_RATE / 2.0, dtype=torch.float64))
    delta = (hi - lo) / (bins + 1)
    left = lo + delta * torch.arange(bins, dtype=torch.float64)
    center, right = left + delta, left + 2 * delta
    m = _mel(torch.arange(FFT // 2 + 1, dtype=torch.float64) * SAMPLE_RATE / FFT)
    up = (m[None, :] - left[:, None]) / (center - left)[:, None]
    down = (right[:, None] - m[None, :]) / (right - center)[:, None]
    inside = (m[None, :] > left[:, None]) & (m[None, :] < right[:, None])
    return torch.where(inside, torch.minimum(up, down), torch.zeros(())).to(device)


def fbank(wave: torch.Tensor, bins: int, standardize: bool = True) -> torch.Tensor:
    """[T] waveform in [-1, 1] -> [F, bins] fp32 log-mel features."""
    x = wave.double() * 32768.0
    n_frames = 1 + (x.shape[0] - WINDOW) // SHIFT if x.shape[0] >= WINDOW else 0
    idx = torch.arange(WINDOW, device=x.device)[None, :] + SHIFT * torch.arange(
        n_frames, device=x.device)[:, None]
    frames = x[idx]
    frames = frames - frames.mean(dim=1, keepdim=True)
    frames = frames - 0.97 * torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
    n = torch.arange(WINDOW, dtype=torch.float64, device=x.device)
    frames = frames * (0.5 - 0.5 * torch.cos(2 * math.pi * n / (WINDOW - 1))) ** 0.85
    power = torch.fft.rfft(frames, n=FFT, dim=1).abs() ** 2
    feats = torch.log(torch.clamp(power @ mel_filters(bins, x.device).T, min=FLT_EPSILON))
    if standardize:
        feats = (feats - feats.mean(dim=0)) / feats.std(dim=0)
    return feats.float()


def linear(x: torch.Tensor, p: Dict[str, torch.Tensor], quant: Optional[str]) -> torch.Tensor:
    if quant == "fp8":
        if "_q" not in p:  # the weight's rounded values, once a layer
            p["_q"] = _fp8(p["kernel"], 0)
        y = _fp8(x, -1) @ p["_q"]
    else:
        y = x @ p["kernel"]
    return y + p["bias"] if "bias" in p else y


def rel_table(s: int, d: int, device: Any) -> torch.Tensor:
    """[2S - 1, D] encodings of distances S - 1 .. -(S - 1)."""
    pos = torch.arange(s - 1, -s, -1, dtype=torch.float64)
    freq = torch.exp(torch.arange(0, d, 2, dtype=torch.float64) * (-math.log(10000.0) / d))
    table = torch.zeros(2 * s - 1, d, dtype=torch.float64)
    table[:, 0::2] = torch.sin(pos[:, None] * freq)
    table[:, 1::2] = torch.cos(pos[:, None] * freq)
    return table.float().to(device)


def rel_shift(bd: torch.Tensor) -> torch.Tensor:
    """[..., S, 2S - 1] scores against the distances S - 1 .. -(S - 1) ->
    [..., S, S]: entry (i, j) the score against distance i - j."""
    *lead, s, m = bd.shape
    x = torch.nn.functional.pad(bd, (1, 0)).reshape(*lead, m + 1, s)
    return x[..., 1:, :].reshape(*lead, s, m)[..., :s]


def rel_attention(x: torch.Tensor, p: Dict[str, Any], heads: int,
                  quant: Optional[str]) -> torch.Tensor:
    """[S, D] -> [S, D]: relative multi-head self-attention."""
    s, d = x.shape
    dh = d // heads

    def split(t):
        return t.reshape(-1, heads, dh).transpose(0, 1)

    q, k, v = (split(linear(x, p[n], quant)) for n in ("q_proj", "k_proj", "v_proj"))
    sdpa = p["sdpa"]
    r = split(linear(rel_table(s, d, x.device), sdpa["r_proj"], quant))     # [H, 2S - 1, Dh]
    ac = (q + sdpa["u_bias"][:, None, :]) @ k.transpose(1, 2)
    bd = rel_shift((q + sdpa["v_bias"][:, None, :]) @ r.transpose(1, 2))
    probs = torch.softmax((ac + bd) / math.sqrt(dh), dim=-1)
    return linear((probs @ v).transpose(0, 1).reshape(s, d), p["output_proj"], quant)


def conv_module(x: torch.Tensor, p: Dict[str, Any], quant: Optional[str]) -> torch.Tensor:
    y = linear(x, p["pointwise_conv1"], quant)
    a, g = y.chunk(2, dim=-1)
    y = a * torch.sigmoid(g)
    w = p["depthwise_conv"]["kernel"][:, 0, :]                            # [K, D]
    k = w.shape[0]
    pad = (k - 1) // 2
    ypad = torch.nn.functional.pad(y, (0, 0, pad, k - 1 - pad))
    y = sum(ypad[i:i + y.shape[0]] * w[i] for i in range(k))
    bn = p["batch_norm"]
    y = (y - bn["running_mean"]) / torch.sqrt(bn["running_var"] + 1e-5) * bn["weight"] + bn["bias"]
    return linear(torch.nn.functional.silu(y), p["pointwise_conv2"], quant)


def half_ffn(x: torch.Tensor, p: Dict[str, Any], quant: Optional[str]) -> torch.Tensor:
    return linear(torch.nn.functional.silu(linear(x, p["inner_proj"], quant)), p["output_proj"],
                  quant)


def conformer_block(x: torch.Tensor, p: Dict[str, Any], heads: int,
                    quant: Optional[str]) -> torch.Tensor:
    x = x + 0.5 * half_ffn(layer_norm(x, p["ffn1_layer_norm"]), p["ffn1"], quant)
    x = x + rel_attention(layer_norm(x, p["self_attn_layer_norm"]), p["self_attn"], heads, quant)
    x = x + conv_module(layer_norm(x, p["conv_layer_norm"]), p["conv"], quant)
    x = x + 0.5 * half_ffn(layer_norm(x, p["ffn2_layer_norm"]), p["ffn2"], quant)
    return layer_norm(x, p["layer_norm"])


def _mha(x, kv, p, heads, quant):
    return linear(attention(linear(x, p["q_proj"], quant), linear(kv, p["k_proj"], quant),
                            linear(kv, p["v_proj"], quant), heads), p["output_proj"], quant)


def pool(memory: torch.Tensor, pooler: Dict[str, Any], cfg: dict,
         quant: Optional[str]) -> torch.Tensor:
    """[S, D] encoded frames -> [D]: the post-LN decoder from BOS."""
    d, heads = cfg["model_dim"], cfg["num_decoder_attn_heads"]
    table = pooler["decoder_frontend"]["embed"]["weight"].float()
    x = table[cfg["bos_idx"]][None, :] * math.sqrt(d) + sinusoidal(1, d, memory.device)
    layers = pooler["decoder"]["layers"]
    for i in range(cfg["num_decoder_layers"]):
        p = _fp32(layers, i)
        x = layer_norm(x + _mha(x, x, p["self_attn"], heads, quant), p["self_attn_layer_norm"])
        x = layer_norm(x + _mha(x, memory, p["encoder_decoder_attn"], heads, quant),
                       p["encoder_decoder_attn_layer_norm"])
        ffn = p["ffn"]
        h = torch.relu(linear(x, ffn["inner_proj"], quant))
        x = layer_norm(x + linear(h, ffn["output_proj"], quant), p["ffn_layer_norm"])
    return linear(x, _fp32(pooler["projection_out"]), quant)[0]


def embed(tree: Dict[str, Any], cfg: dict, waves: Sequence[Any],
          quant: Optional[str] = "bf16") -> torch.Tensor:
    """[len(waves), D] fp32 embeddings of the [T] 16 kHz waveforms (numpy
    arrays or tensors)."""
    quant = None if quant == "bf16" else quant
    dev = tree["layer_norm"]["weight"].device
    heads = cfg["num_encoder_attn_heads"]
    stride = cfg["fbank_stride"]
    with precise(), torch.no_grad():
        front = _fp32(tree["encoder_frontend"])
        xs: List[torch.Tensor] = []
        for w in waves:
            f = fbank(torch.as_tensor(w, device=dev), cfg["num_fbank_channels"])
            s = f.shape[0] // stride
            x = f[: s * stride].reshape(s, -1)
            xs.append(linear(layer_norm(x, front["post_extract_layer_norm"]),
                             front["model_dim_proj"], quant))
        layers = tree["encoder"]["layers"]
        for i in range(cfg["num_encoder_layers"]):
            p = _fp32(layers, i)
            xs = [conformer_block(x, p, heads, quant) for x in xs]
        final = _fp32(tree["layer_norm"])
        return torch.stack([pool(layer_norm(x, final), tree["encoder_pooler"], cfg, quant)
                            for x in xs])
