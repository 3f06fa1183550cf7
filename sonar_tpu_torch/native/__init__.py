"""Native (C++) host components: build-on-demand + ctypes bindings.

The port's own copy of ``sonar_tpu.native``: the SentencePiece unigram
Viterbi encoder (``spm.cpp``) and the ffmpeg-backed audio decoder
(``audio_decode.cpp``), which replace the host-side hot loops that the
reference delegates to the external fairseq2n C++ library.

Each library is compiled with the system toolchain at first use into
``build/sonar_tpu_torch/native/`` at the repository root, under a name that
carries a hash of its sources (an edited source builds a new library; the
sources' directory is never written to). The build goes to a per-process
temporary name and is renamed into place, so concurrent first uses do not
collide. Every consumer has a pure-Python fallback, so a missing compiler
never breaks functionality.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
from pathlib import Path
import subprocess
import threading
from typing import Any, List, Optional

_DIR = Path(__file__).parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sonar_tpu_torch" / "native"
_SOURCES = [_DIR / "spm.cpp"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build(name: str, sources: List[Path], flags: List[str],
           link: List[str]) -> Optional[Path]:
    """Compile ``sources`` into ``BUILD_DIR/<name>.<hash>.so`` unless that
    library exists; None when the toolchain (or a linked library) is
    missing."""
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.read_bytes())
    digest.update(" ".join(flags + link).encode())
    path = BUILD_DIR / f"{name}.{digest.hexdigest()[:16]}.so"
    if path.exists():
        return path
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *flags, "-std=c++17", "-shared", "-fPIC",
           *(str(s) for s in sources), *link, "-o", str(tmp)]
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return path
    except (subprocess.SubprocessError, OSError):
        return None
    finally:
        tmp.unlink(missing_ok=True)


def load_library() -> Optional[ctypes.CDLL]:
    """Compile (if stale) and load the native library; None on failure."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build("_sonar_native", _SOURCES, ["-O3"], [])
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.spm_create.restype = ctypes.c_void_p
        lib.spm_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_float,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.spm_destroy.argtypes = [ctypes.c_void_p]
        lib.spm_encode.restype = ctypes.c_int32
        lib.spm_encode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.spm_set_normalizer.restype = ctypes.c_int32
        lib.spm_set_normalizer.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int32,
        ]
        lib.spm_normalize.restype = ctypes.c_int32
        lib.spm_normalize.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.c_char_p,
            ctypes.c_int32,
        ]
        lib.spm_encode_batch.restype = ctypes.c_int32
        lib.spm_encode_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ]
        lib.spm_free_ids.argtypes = [ctypes.POINTER(ctypes.c_int32)]
        lib.spm_free_offsets.argtypes = [ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
        return _lib


# -- audio decoding (ffmpeg libraries) ---------------------------------------

_AUDIO_SOURCES = [_DIR / "audio_decode.cpp"]
_AUDIO_LINK = ["-lavformat", "-lavcodec", "-lavutil", "-lswresample"]

_audio_lib: Optional[ctypes.CDLL] = None
_audio_tried = False


def load_audio_library() -> Optional[ctypes.CDLL]:
    """Compile (if stale) and load the ffmpeg-backed decoder; None when the
    toolchain or the ffmpeg dev libraries are unavailable."""
    global _audio_lib, _audio_tried
    with _lock:
        if _audio_lib is not None or _audio_tried:
            return _audio_lib
        _audio_tried = True
        path = _build("_sonar_audio", _AUDIO_SOURCES, ["-O2"], _AUDIO_LINK)
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.sonar_audio_decode.restype = ctypes.c_int32
        lib.sonar_audio_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.sonar_audio_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        _audio_lib = lib
        return _audio_lib


def decode_audio_bytes(data: bytes) -> Any:
    """Decode any ffmpeg-supported audio blob -> (float32 [T, C], rate).

    Raises ValueError when the native decoder is unavailable or the blob
    cannot be decoded.
    """
    import numpy as np

    lib = load_audio_library()
    if lib is None:
        raise ValueError(
            "native audio decoder unavailable (ffmpeg libraries not found); "
            "only RIFF/WAV input is supported"
        )
    out = ctypes.POINTER(ctypes.c_float)()
    n_frames = ctypes.c_int64()
    rate = ctypes.c_int32()
    channels = ctypes.c_int32()
    rc = lib.sonar_audio_decode(
        data, len(data), ctypes.byref(out), ctypes.byref(n_frames),
        ctypes.byref(rate), ctypes.byref(channels),
    )
    if rc != 0:
        raise ValueError(f"audio decode failed (ffmpeg error {rc})")
    try:
        n = n_frames.value * channels.value
        wave = np.ctypeslib.as_array(out, shape=(n,)).astype(np.float32, copy=True)
    finally:
        lib.sonar_audio_free(out)
    return wave.reshape(n_frames.value, channels.value), float(rate.value)


class NativeSpmEncoder:
    """ctypes wrapper over the C++ Viterbi core; one instance per model."""

    def __init__(self, pieces: Any, ids: Any, scores: Any, unk_id: int, unk_score: float,
                 byte_ids: dict):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        n = len(pieces)
        arr = (ctypes.c_char_p * n)(*[p.encode("utf-8") for p in pieces])
        idc = (ctypes.c_int32 * n)(*ids)
        sc = (ctypes.c_float * n)(*scores)
        bt = (ctypes.c_int32 * 256)(*[byte_ids.get(b, -1) for b in range(256)])
        self._handle = lib.spm_create(
            arr, idc, sc, n, unk_id if unk_id is not None else 0,
            ctypes.c_float(unk_score), bt,
        )
        self._out_cap = 4096
        self._out = (ctypes.c_int32 * self._out_cap)()
        self._normalizer_set = False

    def encode_normalized(self, text: str) -> Any:
        data = text.encode("utf-8")
        while True:
            n = self._lib.spm_encode(
                self._handle, data, len(data), self._out, self._out_cap
            )
            if n >= 0:
                return list(self._out[:n])
            self._out_cap *= 4
            self._out = (ctypes.c_int32 * self._out_cap)()

    def set_normalizer(
        self,
        charsmap: bytes,
        remove_extra_whitespaces: bool,
        add_dummy_prefix: bool,
        escape_whitespaces: bool,
    ) -> None:
        """Install the C++ normalizer (precompiled charsmap or identity +
        whitespace phase). Raises on a malformed charsmap blob."""
        flags = (
            (1 if remove_extra_whitespaces else 0)
            | (2 if add_dummy_prefix else 0)
            | (4 if escape_whitespaces else 0)
        )
        rc = self._lib.spm_set_normalizer(
            self._handle, charsmap or None, len(charsmap or b""), flags
        )
        if rc != 0:
            raise ValueError("malformed precompiled charsmap blob")
        self._normalizer_set = True

    @property
    def normalizer_set(self) -> bool:
        return self._normalizer_set

    def normalize(self, text: str) -> str:
        """Run the installed C++ normalizer (testing seam)."""
        data = text.encode("utf-8")
        cap = 4 * len(data) + 16
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.spm_normalize(self._handle, data, len(data), buf, cap)
            if n == -2:
                raise RuntimeError("normalizer not installed")
            if n >= 0:
                return buf.raw[:n].decode("utf-8", errors="replace")
            cap *= 4

    def encode_batch(self, texts: Any, pre_normalized: bool, num_threads: int) -> Any:
        """Tokenize a batch in one GIL-releasing native call.

        Returns a list of id lists. ``pre_normalized=False`` runs the
        installed C++ normalizer per string (``set_normalizer`` first).
        """
        return self.encode_batch_blobs(
            [t.encode("utf-8") for t in texts], pre_normalized, num_threads
        )

    def encode_batch_blobs(
        self, blobs: Any, pre_normalized: bool, num_threads: int
    ) -> Any:
        """Like ``encode_batch`` but over pre-encoded UTF-8 byte strings
        (lets the caller do its one UTF-8 pass and keep the blobs)."""
        n = len(blobs)
        offsets = (ctypes.c_int64 * (n + 1))()
        pos = 0
        for i, b in enumerate(blobs):
            offsets[i] = pos
            pos += len(b)
        offsets[n] = pos
        data = b"".join(blobs)
        out_ids = ctypes.POINTER(ctypes.c_int32)()
        out_offs = ctypes.POINTER(ctypes.c_int64)()
        rc = self._lib.spm_encode_batch(
            self._handle, data, offsets, n,
            0 if pre_normalized else 1, num_threads,
            ctypes.byref(out_ids), ctypes.byref(out_offs),
        )
        if rc == -2:
            raise RuntimeError("normalizer not installed")
        if rc != 0:
            raise MemoryError("spm_encode_batch failed")
        try:
            offs = out_offs[: n + 1]  # ctypes bulk slice (C-level copy)
            flat = out_ids[: offs[n]]
            results = [flat[offs[i]:offs[i + 1]] for i in range(n)]
        finally:
            self._lib.spm_free_ids(out_ids)
            self._lib.spm_free_offsets(out_offs)
        return results

    def __del__(self):
        try:
            self._lib.spm_destroy(self._handle)
        except Exception:
            pass
