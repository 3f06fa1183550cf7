"""Kaldi-compatible log-mel filterbank on the device (``sonar_tpu.ops.fbank``).

The speech pipelines' front end, computed on the model's device: framing
(snip_edges), DC removal, preemphasis 0.97, povey window, 512-point rFFT
power spectrum, mel projection in true fp32, ``log(max(x, FLT_EPSILON))``,
and per-utterance standardisation over the valid frames. Plain PyTorch:
the JAX module is plain ``jnp`` too, not a kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
import functools
from typing import Any, Tuple

import numpy as np
from sonar_tpu_torch.ops.precision import matmul_precision_for
import torch

FLT_EPSILON = 1.1920928955078125e-07


@dataclass(frozen=True)
class FbankConfig:
    sample_rate: int = 16000
    num_mel_bins: int = 80
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    low_freq: float = 20.0
    high_freq: float = 0.0  # 0 => Nyquist
    preemphasis: float = 0.97
    waveform_scale: float = 32768.0
    standardize: bool = True
    remove_dc_offset: bool = True

    @property
    def window_size(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def window_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000.0)

    @property
    def fft_size(self) -> int:
        n = 1
        while n < self.window_size:
            n <<= 1
        return n


def mel_scale(freq: Any) -> Any:
    return 1127.0 * np.log(1.0 + np.asarray(freq) / 700.0)


def mel_banks(config: FbankConfig) -> np.ndarray:
    """[num_bins, fft_size//2 + 1] triangular filters (Kaldi MelBanks)."""
    n_fft = config.fft_size
    nyquist = config.sample_rate / 2.0
    high = config.high_freq if config.high_freq > 0 else nyquist + config.high_freq
    # Kaldi places num_bins + 2 edges uniformly in mel space.
    edges = np.linspace(mel_scale(config.low_freq), mel_scale(high), config.num_mel_bins + 2)
    fft_mels = mel_scale(np.arange(n_fft // 2 + 1) * (config.sample_rate / n_fft))
    left, center, right = edges[:-2][:, None], edges[1:-1][:, None], edges[2:][:, None]
    up = (fft_mels[None, :] - left) / (center - left)
    down = (right - fft_mels[None, :]) / (right - center)
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


def povey_window(n: int) -> np.ndarray:
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
    return np.power(hann, 0.85).astype(np.float32)


def num_frames(num_samples: int, config: FbankConfig) -> int:
    """snip_edges frame count."""
    if num_samples < config.window_size:
        return 0
    return 1 + (num_samples - config.window_size) // config.window_shift


@functools.lru_cache(maxsize=8)
def _tables(config: FbankConfig, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(povey window [win], mel banks [M, K]) as fp32 tensors on ``device``
    (read only)."""
    return (torch.from_numpy(povey_window(config.window_size)).to(device),
            torch.from_numpy(mel_banks(config)).to(device))


def _log_mel(frames: torch.Tensor, config: FbankConfig) -> torch.Tensor:
    """[..., F, win] fp32 frames -> [..., F, M] log-mel energies."""
    if config.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if config.preemphasis > 0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - config.preemphasis * prev
    window, banks = _tables(config, frames.device)
    spec = torch.fft.rfft(frames * window, n=config.fft_size, dim=-1)
    power = spec.real.square() + spec.imag.square()
    # True fp32: the energies feed a log, where quiet bins amplify any
    # product error (the JAX module asks for HIGHEST precision here).
    with matmul_precision_for(torch.float32):
        mel = power @ banks.t()
    return torch.log(torch.clamp(mel, min=FLT_EPSILON))


def batched_fbank(
    waveforms: torch.Tensor,
    wave_lens: torch.Tensor,
    max_frames: int,
    config: FbankConfig = FbankConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded batch [B, T] + lens [B] -> (fp32 [B, max_frames, M], frame_lens
    int32 [B]). Frames past each utterance's count are zero; the
    standardisation (mean, unbiased variance) covers the valid frames only."""
    b = waveforms.shape[0]
    win, shift = config.window_size, config.window_shift
    wave = waveforms.float() * config.waveform_scale
    if max_frames > 0:
        need = (max_frames - 1) * shift + win
        if wave.shape[1] < need:
            wave = torch.nn.functional.pad(wave, (0, need - wave.shape[1]))
        frames = wave.unfold(1, win, shift)[:, :max_frames]            # [B, F, win]
        feats = _log_mel(frames, config)
    else:
        feats = wave.new_zeros((b, 0, config.num_mel_bins))
    lens = wave_lens.to(device=wave.device, dtype=torch.int64)
    frame_lens = torch.where(lens >= win, 1 + (lens - win) // shift, torch.zeros_like(lens))
    frame_lens = torch.clamp(frame_lens, max=max_frames).to(torch.int32)
    mask = (torch.arange(max_frames, device=wave.device)[None, :] < frame_lens[:, None])[..., None]
    zero = feats.new_zeros(())
    feats = torch.where(mask, feats, zero)
    if config.standardize:
        denom = torch.clamp(frame_lens.float(), min=1.0)[:, None, None]
        mean = feats.sum(dim=1, keepdim=True) / denom
        var = torch.where(mask, (feats - mean).square(), zero).sum(dim=1, keepdim=True) / (
            torch.clamp(denom - 1.0, min=1.0))
        feats = torch.where(mask, (feats - mean) * torch.rsqrt(var + 1e-20), zero)
    return feats, frame_lens
