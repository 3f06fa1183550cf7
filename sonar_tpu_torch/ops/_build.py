"""Build and load the port's CUDA kernels.

The sources under ``sonar_tpu_torch/csrc/`` are compiled by ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface, at
first use, into ``build/sonar_tpu_torch/`` at the repository root: one
``nvcc`` per source file, all started together, then one link. The build
is keyed by a hash of the sources: an unchanged tree reuses the library, an
edited one rebuilds it. A failed build raises with the compiler's output;
there is no fallback.

The library is bound with ``ctypes``: pointers and the stream are passed as
``c_void_p``; every entry returns ``cudaGetLastError()`` and ``check``
raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
from pathlib import Path
import shutil
import subprocess
import threading
from typing import Optional

from sonar_tpu_torch.utils.profiling import span

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sonar_tpu_torch"
LIB_NAME = "libsonar_tpu_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "sonar_short_qkv_attention": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "sonar_flash_attention": (
        [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I] + [_LL] * 9 + [_I, _P]
    ),
    "sonar_fused_int8_ffn": [_P, _I, _I, _I, _I, _I] + [_P] * 14 + [_P],
    "sonar_fused_bf16_ffn": [_P] + [_I] * 5 + [ctypes.c_float] + [_P] * 9 + [_P],
    "sonar_fused_attn_block": [_P, _I, _I, _I, _I, _I] + [_P] * 16 + [_P],
    "sonar_attn_one_pass_max": [ctypes.POINTER(_I)],
    "sonar_relpos_v2_workspace": [_I, _I, _I, _I, _P],
    "sonar_relpos_flash_v2": [_P] * 12 + [_LL] + [_I] * 5 + [_LL] * 9 + [_I, _P],
    "sonar_relpos_flash_v1": [_P] * 7 + [_I] * 4 + [_LL] * 9 + [_I, _P],
    "sonar_beam_masked_tiles": [_I, _I, _P, _P],
    "sonar_beam_masked_attend": [_P] * 7 + [_I] * 6 + [ctypes.c_float, _I, _P],
    "sonar_beam_diag_attend": [_P] * 5 + [_I] * 6 + [_P],
    "sonar_beam_reorder_attend": [_P] * 11 + [_I] * 6 + [_P],
    "sonar_check_softmax_division": [ctypes.c_ulonglong, ctypes.c_ulonglong, _P, _P],
    "sonar_gumbel_max": [_P, _P, _P, _LL, _I, _I, _P, _P, _P, _P],
    "sonar_graph_while": [_P, _P, ctypes.POINTER(_P)],
    "sonar_graph_launch": [_P, _P],
    "sonar_graph_exec_destroy": [_P],
    "sonar_add_layer_norm": [_P, _P, _I, _LL, _I, ctypes.c_float, _P, _P, _I, _P, _P, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists.

    Writes ``nvcc.log`` (the compiler's output, register and shared-memory
    use per kernel) beside the library.
    """
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
    nvcc = _nvcc()
    pipe = dict(stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    procs = [(cmd, subprocess.Popen(cmd, **pipe)) for cmd in (
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(srcs, objs))]
    runs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in procs]
    if all(rc == 0 for _, _, rc in runs):
        link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, **pipe)
        runs.append((link, proc.stdout, proc.returncode))
    for obj in objs:
        obj.unlink(missing_ok=True)
    (BUILD_DIR / "nvcc.log").write_text("\n".join(f"$ {' '.join(c)}\n{o}" for c, o, _ in runs))
    failed = [f"{' '.join(c)} (exit code {rc}):\n{o}" for c, o, rc in runs if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (a ``runtime.build``
    span: compiled, or loaded from an earlier build)."""
    global _lib
    with _lock:
        if _lib is None:
            with span("runtime.build"):
                lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.sonar_error_string.argtypes = [ctypes.c_int]
            lib.sonar_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = library().sonar_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()
