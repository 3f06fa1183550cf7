"""Audio decoding + file mapping (host side).

Replaces fairseq2n's C++ ``AudioDecoder`` (libsndfile) and ``FileMapper``
(reference usage: ``sonar/inference_pipelines/speech.py:23,118,296-308``).
Two decode paths:

- RIFF/WAVE: native numpy parser (PCM 8/16/24/32-bit and IEEE float,
  mono/multichannel) — no external library, always available;
- everything else (flac, ogg/vorbis, opus, mp3, ...): the C++ ffmpeg
  binding in ``sonar_tpu_torch/native/audio_decode.cpp`` (libavformat/avcodec),
  which exceeds the reference's libsndfile format coverage. When neither
  the prebuilt library nor a toolchain+ffmpeg-dev is present, non-WAV input
  raises a clear ValueError.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
import struct
from typing import Any, Dict, Union

import numpy as np


@dataclass
class DecodedAudio:
    waveform: np.ndarray  # [T, C] float32 in [-1, 1]
    sample_rate: float
    format: int = -1

    def as_dict(self) -> Dict:
        return {
            "waveform": self.waveform,
            "sample_rate": self.sample_rate,
            "format": self.format,
        }


def decode_wav_bytes(data: bytes) -> DecodedAudio:
    """Parse a RIFF/WAVE blob -> float32 [T, C] in [-1, 1]; other containers
    route to the native ffmpeg decoder."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        return _decode_with_ffmpeg(data)
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_ext = body[16:]
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError("malformed wav: missing fmt/data chunk")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        # The real codec is the first 2 bytes of the SubFormat GUID in the
        # fmt extension (cbSize [2] + validBits [2] + channelMask [4] then
        # the GUID [16]); guessing from the bit depth misreads 32-bit PCM
        # extensible files as IEEE float and vice versa.
        if len(fmt_ext) >= 8 + 2:
            (audio_format,) = struct.unpack("<H", fmt_ext[8:10])
        else:
            raise ValueError("malformed extensible wav: truncated fmt chunk")

    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 8:
            x = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, "u1").reshape(-1, 3)
            val = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            val = np.where(val >= 1 << 23, val - (1 << 24), val)
            x = val.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / float(1 << 31)
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(raw, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"unsupported wav format code: {audio_format}")

    if channels > 1:
        x = x.reshape(-1, channels)
    else:
        x = x.reshape(-1, 1)
    return DecodedAudio(waveform=x, sample_rate=float(rate))


def _decode_with_ffmpeg(data: bytes) -> DecodedAudio:
    from sonar_tpu_torch.native import decode_audio_bytes

    wave, rate = decode_audio_bytes(data)
    return DecodedAudio(waveform=wave, sample_rate=rate)


class AudioDecoder:
    """Callable: bytes | path | array -> dict(waveform [T,C], sample_rate)."""

    def __call__(self, inp: Union[bytes, str, Path, np.ndarray]) -> Dict:
        if isinstance(inp, np.ndarray):
            wave = np.asarray(inp, np.float32)
            if wave.ndim == 1:
                wave = wave[:, None]
            elif wave.shape[0] < wave.shape[1]:  # [C, T] -> [T, C]
                wave = wave.T
            return DecodedAudio(wave, 16000.0).as_dict()
        if isinstance(inp, (str, Path)):
            inp = Path(inp).read_bytes()
        return decode_wav_bytes(inp).as_dict()


class FileMapper:
    """Resolve relative paths under a root dir and read bytes.

    Supports fairseq2-style ``path[:offset[:length]]`` byte-window syntax
    used in TSV manifests (``FileMapper`` at ``speech.py:109-112``).
    """

    def __init__(self, root_dir: Union[str, Path, None] = None, cached_fd_count: int = 10):
        self.root_dir = Path(root_dir) if root_dir else None

    def __call__(self, pathname: str) -> Dict:
        parts = str(pathname).split(":")
        rel, offset, length = parts[0], None, None
        if len(parts) >= 2 and parts[1].isdigit():
            offset = int(parts[1])
        if len(parts) >= 3 and parts[2].isdigit():
            length = int(parts[2])
        path = (self.root_dir / rel) if self.root_dir else Path(rel)
        data = path.read_bytes()
        if offset is not None:
            # `length is not None`: an explicit zero-length window must give
            # an empty slice, not the whole tail.
            data = (
                data[offset : offset + length]
                if length is not None
                else data[offset:]
            )
        return {"path": str(path), "data": data}


def write_wav(path: Union[str, Path], waveform: np.ndarray, sample_rate: int = 16000) -> Any:
    """Write mono/multi PCM16 wav (test fixtures)."""
    x = np.asarray(waveform)
    if x.ndim == 1:
        x = x[:, None]
    pcm = np.clip(x * 32767.0, -32768, 32767).astype("<i2")
    channels = pcm.shape[1]
    byte_rate = sample_rate * channels * 2
    data = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, channels, sample_rate, byte_rate, channels * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)
