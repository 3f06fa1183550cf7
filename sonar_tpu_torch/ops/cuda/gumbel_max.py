"""The sampling step's draw: Gumbel-max with JAX's threefry noise.

Replaces no Pallas kernel: the JAX package draws a token with
``jax.random.categorical(fold_in(PRNGKey(seed), step), filtered)``
(``sonar_tpu/generation/sampling.py:123-124``), which XLA computes. The
CUDA kernel ``csrc/gumbel_max.cu`` computes the same function on the card
from the key's two uint32 words and the device step counter, so that a
captured sampling step draws fresh noise at every turn of a loop on the
device and the port samples the tokens JAX samples from the same seed.

The noise is JAX 0.9's in its default partitionable threefry mode:
``PRNGKey(seed)`` is the words (0, seed mod 2^32); ``fold_in(key, step)``
is ``threefry2x32(key, (0, step))``; element (r, v) of a [B, V] draw hashes
its flat index c = r * V + v, split into 32-bit halves, and keeps the xor
of the two output words; u = max(tiny, float(bits >> 9 in [1, 2)) - 1 +
tiny); g = -log(-log(u)). ``row0`` offsets r, so that a rank of a data
split draws the rows of the whole batch it holds.

``gumbel_max_plain`` is the same in PyTorch: threefry on int64 tensors
masked to 32 bits, ``torch.log``, ``torch.argmax``. The kernel's noise is
the plain version's bit for bit on the card; JAX's ``log`` differs from
``torch.log`` in the last bit on some elements (the tests hold the noise
within 1e-6 and the bits equal).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

from sonar_tpu_torch.ops import _build
from sonar_tpu_torch.ops.cuda import launched
from sonar_tpu_torch.ops.cuda.int8_blocks import check_cuda, require
import torch

LAUNCHES = 0
M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = torch.finfo(torch.float32).tiny


def prng_key(seed: int, device: Any = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s words as an int64 tensor [2]: (0,
    seed mod 2^32), as the JAX package runs (64-bit integers off)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0: Any, k1: Any, x0: Any, x1: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _as_step(step: Union[int, torch.Tensor], device: Any) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int64, device=device) & M32


def threefry_bits(key: torch.Tensor, step: Union[int, torch.Tensor], row0: int, b: int,
                  v: int) -> torch.Tensor:
    """``jax.random.bits(fold_in(key, step), (row0 + b, v), uint32)[row0:]``
    as int64 [b, v]."""
    dev = key.device
    k0, k1 = threefry2x32(key[0], key[1], torch.zeros((), dtype=torch.int64, device=dev),
                          _as_step(step, dev))
    rows = torch.arange(row0, row0 + b, dtype=torch.int64, device=dev)
    c = rows[:, None] * v + torch.arange(v, dtype=torch.int64, device=dev)[None, :]
    x0, x1 = threefry2x32(k0, k1, c >> 32, c & M32)
    return x0 ^ x1


def threefry_gumbel(key: torch.Tensor, step: Union[int, torch.Tensor], row0: int, b: int,
                    v: int) -> torch.Tensor:
    """``jax.random.gumbel(fold_in(key, step), (row0 + b, v))[row0:]``, fp32
    [b, v] on ``key``'s device."""
    bits = threefry_bits(key, step, row0, b, v)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(f + TINY, TINY)
    return -torch.log(-torch.log(u))


def gumbel_max_plain(filtered: torch.Tensor, key: torch.Tensor, step: Union[int, torch.Tensor],
                     row0: int = 0, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """argmax(filtered + threefry_gumbel(key, step, row0, B, V)) over the
    last axis, int64 [B] (ties to the lower index); writes the noise into
    ``noise`` when given."""
    b, v = filtered.shape
    g = threefry_gumbel(key, step, row0, b, v)
    if noise is not None:
        noise.copy_(g)
    return torch.argmax(filtered.float() + g, dim=-1)


def gumbel_max(filtered: torch.Tensor, key: torch.Tensor, step: torch.Tensor, row0: int = 0,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sampled token of each row, int64 [B]: filtered [B, V] fp32 (the
    filtered log-probabilities), key [2] int64 (``prng_key``), step a 0-d
    int64 tensor (the device step counter), row0 the first row's global
    index. ``noise`` ([B, V] fp32), when given, receives the Gumbel draw
    (for checks; None on the sampling path)."""
    if not filtered.is_cuda:
        return gumbel_max_plain(filtered, key, step, row0, noise)
    dev = filtered.device
    require(filtered.dim() == 2, f"filtered must be [B, V], got {tuple(filtered.shape)}")
    b, v = filtered.shape
    require(row0 >= 0, f"row0 must be >= 0, got {row0}")
    check_cuda("filtered", filtered, dev, torch.float32)
    check_cuda("key", key, dev, torch.int64, (2,))
    check_cuda("step", step, dev, torch.int64, ())
    check_cuda("noise", noise, dev, torch.float32, (b, v))
    scratch = torch.zeros(2 * b, dtype=torch.int64, device=dev)
    tok = torch.empty(b, dtype=torch.int64, device=dev)
    _build.check(
        _build.library().sonar_gumbel_max(
            filtered.data_ptr(), key.data_ptr(), step.data_ptr(), row0, b, v,
            scratch.data_ptr(), tok.data_ptr(), _build.ptr(noise), _build.stream_of(filtered)),
        "gumbel_max",
    )
    launched("gumbel_max", "LAUNCHES")
    return tok
