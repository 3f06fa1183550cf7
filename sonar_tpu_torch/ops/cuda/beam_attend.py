"""Beam-decode self-attention over the un-reordered KV cache.

Port of ``sonar_tpu/ops/pallas/beam_attend.py``; the CUDA kernels are in
``csrc/beam_masked.cu`` (the masked attend; its fp32 body in
``csrc/beam_attend.cu``), ``csrc/beam_diag.cu`` (the diagonal attend) and
``csrc/beam_reorder.cu`` (the reorder). Three functions, each with its plain PyTorch version (taken for
CPU tensors) and a launch count:

- ``beam_masked_attend``: each of the K query beams attends every cache row
  and position its ancestry names (the core of ``_beam_self_attend``, on
  the beam-decode path);
- ``beam_diag_attend``: beam row k attends its own cache row;
- ``beam_reorder_attend``: gather each row's winner history, write this
  step's K/V at the write position, then the diagonal attend; returns new
  caches.

The last two are the physical-reorder form of the same decode step, which
no path of either package calls; they are ported beside it.

Numerics are the TPU kernels': q scaled in fp32, an additive bias
``(allow - 1) * 1e30 + valid_bias``, fp32 softmax with a true division and
fp32 P @ V, the output cast to the input dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

from sonar_tpu_torch.ops import _build
from sonar_tpu_torch.ops.cuda import launched
from sonar_tpu_torch.ops.attention import softmax
from sonar_tpu_torch.ops.cuda.int8_blocks import check_cuda, require
import torch

# Launch counts. A captured beam step launches the masked attend at each
# replay too: the runtime adds those (``ops.cuda.add_launches``).
MASKED_LAUNCHES = 0
DIAG_LAUNCHES = 0
REORDER_LAUNCHES = 0
DIAG_MAX_POSITIONS = 32768  # the diagonal attend keeps a row's logits in shared memory
_KIND = {torch.float32: 0, torch.bfloat16: 1}


# -- plain versions ------------------------------------------------------------------


def beam_masked_attend_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                             anc: torch.Tensor, valid_bias: torch.Tensor,
                             num_heads: int) -> torch.Tensor:
    bh, beam, dh = q.shape
    c, s = k_cache.shape[1], k_cache.shape[2]
    rows = torch.arange(c, device=q.device)
    allow = (anc.long()[:, :, None, :] == rows[None, None, :, None]).float()  # [B, K, C, S]
    bias = (allow - 1.0) * 1e30 + valid_bias.float()
    bias = bias.repeat_interleave(num_heads, dim=0)                         # [BH, K, C, S]
    qs = q.float() * (dh ** -0.5)
    logits = torch.einsum("nqd,ncsd->nqcs", qs, k_cache.float()) + bias
    p = softmax(logits.reshape(bh, beam, c * s)).reshape(bh, beam, c, s)
    return torch.einsum("nqcs,ncsd->nqd", p, v_cache.float()).to(q.dtype)


def beam_diag_attend_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           valid_bias: torch.Tensor) -> torch.Tensor:
    dh = q.shape[-1]
    qs = q.float().permute(0, 2, 1, 3) * (dh ** -0.5)                      # [B, H, K, Dh]
    logits = torch.einsum("bhkd,bhksd->bhks", qs, k_cache.float()) + valid_bias.float()
    out = torch.einsum("bhks,bhksd->bhkd", softmax(logits), v_cache.float())
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _reorder_write(cache: torch.Tensor, new: torch.Tensor, sel: torch.Tensor,
                   write_onehot: torch.Tensor) -> torch.Tensor:
    """fp32 [B, H, K, S, Dh]: the rows ``sel`` names, with ``new`` at the
    write position."""
    b, h, k, s, dh = cache.shape
    idx = sel.long()[:, None, :, None, None].expand(b, h, k, s, dh)
    gathered = torch.gather(cache, 2, idx).float()
    at = (write_onehot != 0)[None, None, None, :, None]
    return torch.where(at, new.float().permute(0, 2, 1, 3)[:, :, :, None, :], gathered)


def beam_reorder_attend_plain(q, k_new, v_new, k_cache, v_cache, sel, valid_bias,
                              write_onehot) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    kk = _reorder_write(k_cache, k_new, sel, write_onehot)
    vv = _reorder_write(v_cache, v_new, sel, write_onehot)
    out = beam_diag_attend_plain(q.float(), kk, vv, valid_bias).to(q.dtype)
    return out, kk.to(k_cache.dtype), vv.to(v_cache.dtype)


# -- kernels ---------------------------------------------------------------------------


def _check_common(q: torch.Tensor, caches, valid_bias: torch.Tensor) -> None:
    require(q.dtype in _KIND, f"fp32 and bf16 only, got {q.dtype}")
    dh = q.shape[-1]
    require(dh in (32, 64, 128), f"head dim {dh} not in (32, 64, 128)")
    for name, t in caches:
        check_cuda(name, t, q.device, q.dtype)
    check_cuda("q", q, q.device)
    check_cuda("valid_bias", valid_bias, q.device, torch.float32, (caches[0][1].shape[-2],))


@functools.lru_cache(maxsize=None)
def masked_tiles(bh: int, s: int) -> Tuple[int, int]:
    """(positions a block, blocks a (sentence, head)) of the bf16 masked
    attend kernel at B*H = ``bh`` and a cache of ``s`` positions: more than
    one block a head means fp32 partials in a workspace and a combining
    launch. A captured beam step finds its shape here already: the runtime
    runs one step eagerly before it captures."""
    tile, nsplit = ctypes.c_int(), ctypes.c_int()
    _build.check(_build.library().sonar_beam_masked_tiles(bh, s, ctypes.byref(tile),
                                                           ctypes.byref(nsplit)),
                 "beam_masked_attend tiles")
    return tile.value, nsplit.value


def beam_masked_attend(
    q: torch.Tensor,           # [B*H, K, Dh] unscaled, b-major
    k_cache: torch.Tensor,     # [B*H, C, S, Dh] (view of [B, H, C, S, Dh])
    v_cache: torch.Tensor,
    anc: torch.Tensor,         # [B, K, S] int32 cache row per (query beam, position)
    valid_bias: torch.Tensor,  # [S] fp32 additive (0 for s <= idx, -1e30 after)
    num_heads: int,
) -> torch.Tensor:
    """Ancestry-masked beam self-attend -> [B*H, K, Dh] in q's dtype."""
    if not q.is_cuda:
        return beam_masked_attend_plain(q, k_cache, v_cache, anc, valid_bias, num_heads)
    bh, beam, dh = q.shape
    require(k_cache.dim() == 4 and k_cache.shape[0] == bh and k_cache.shape[-1] == dh,
            f"k_cache must be [{bh}, C, S, {dh}], got {tuple(k_cache.shape)}")
    require(bh % num_heads == 0, f"{bh} rows are not a multiple of {num_heads} heads")
    require(beam <= 16, f"at most 16 beams, got {beam}")
    _, c, s, _ = k_cache.shape
    require(1 <= c <= 32, f"1 to 32 cache rows a sentence, got {c}")
    _check_common(q, [("k_cache", k_cache), ("v_cache", v_cache)], valid_bias)
    require(tuple(v_cache.shape) == tuple(k_cache.shape), "v_cache must match k_cache")
    check_cuda("anc", anc, q.device, torch.int32, (bh // num_heads, beam, s))
    out = torch.empty_like(q)
    # bf16 splits a long cache over blocks whose fp32 partials a second launch
    # combines; fp32 runs one block a (sentence, head).
    nsplit = masked_tiles(bh, s)[1] if q.dtype == torch.bfloat16 else 1
    part = (torch.empty((bh, nsplit, beam, dh + 2), dtype=torch.float32, device=q.device)
            if nsplit > 1 else None)
    _build.check(
        _build.library().sonar_beam_masked_attend(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), anc.data_ptr(),
            valid_bias.data_ptr(), out.data_ptr(), _build.ptr(part), bh, num_heads, beam, c,
            s, dh, dh ** -0.5, _KIND[q.dtype], _build.stream_of(q),
        ),
        "beam_masked_attend",
    )
    launched("beam_attend", "MASKED_LAUNCHES")
    return out


def beam_diag_attend(
    q: torch.Tensor,           # [B, K, H, Dh] unscaled
    k_cache: torch.Tensor,     # [B, H, K, S, Dh]
    v_cache: torch.Tensor,
    valid_bias: torch.Tensor,  # [S] fp32 additive
) -> torch.Tensor:
    """Diagonal attend (beam row k attends its own cache row) -> [B, K, H, Dh]."""
    if not q.is_cuda:
        return beam_diag_attend_plain(q, k_cache, v_cache, valid_bias)
    b, beam, h, dh = q.shape
    require(beam <= 16, f"at most 16 beams, got {beam}")
    require(k_cache.dim() == 5 and tuple(k_cache.shape[:3]) == (b, h, beam),
            f"k_cache must be [{b}, {h}, {beam}, S, {dh}], got {tuple(k_cache.shape)}")
    _check_common(q, [("k_cache", k_cache), ("v_cache", v_cache)], valid_bias)
    require(tuple(v_cache.shape) == tuple(k_cache.shape), "v_cache must match k_cache")
    s = k_cache.shape[3]
    require(s <= DIAG_MAX_POSITIONS, f"at most {DIAG_MAX_POSITIONS} positions, got {s}")
    out = torch.empty_like(q)
    lib = _build.library()
    _build.check(
        lib.sonar_beam_diag_attend(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid_bias.data_ptr(),
            out.data_ptr(), b, h, beam, s, dh, _KIND[q.dtype], _build.stream_of(q),
        ),
        "beam_diag_attend",
    )
    launched("beam_attend", "DIAG_LAUNCHES")
    return out


def beam_reorder_attend(
    q: torch.Tensor,             # [B, K, H, Dh] unscaled
    k_new: torch.Tensor,         # [B, K, H, Dh] this step's keys per row
    v_new: torch.Tensor,
    k_cache: torch.Tensor,       # [B, H, K, S, Dh] before the reorder
    v_cache: torch.Tensor,
    sel: torch.Tensor,           # [B, K] int32 winner row each beam inherits from
    valid_bias: torch.Tensor,    # [S] fp32 additive
    write_onehot: torch.Tensor,  # [S] fp32, 1.0 at the write position
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (attended [B, K, H, Dh], k_cache' [B, H, K, S, Dh], v_cache')."""
    if not q.is_cuda:
        return beam_reorder_attend_plain(q, k_new, v_new, k_cache, v_cache, sel, valid_bias,
                                         write_onehot)
    b, beam, h, dh = q.shape
    require(beam <= 16, f"at most 16 beams, got {beam}")
    require(k_cache.dim() == 5 and tuple(k_cache.shape[:3]) == (b, h, beam),
            f"k_cache must be [{b}, {h}, {beam}, S, {dh}], got {tuple(k_cache.shape)}")
    _check_common(q, [("k_cache", k_cache), ("v_cache", v_cache), ("k_new", k_new),
                      ("v_new", v_new)], valid_bias)
    require(tuple(v_cache.shape) == tuple(k_cache.shape), "v_cache must match k_cache")
    require(tuple(k_new.shape) == tuple(q.shape) and tuple(v_new.shape) == tuple(q.shape),
            "k_new and v_new must be shaped like q")
    s = k_cache.shape[3]
    check_cuda("sel", sel, q.device, torch.int32, (b, beam))
    check_cuda("write_onehot", write_onehot, q.device, torch.float32, (s,))
    out = torch.empty_like(q)
    k_out, v_out = torch.empty_like(k_cache), torch.empty_like(v_cache)
    lib = _build.library()
    _build.check(
        lib.sonar_beam_reorder_attend(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), sel.data_ptr(), valid_bias.data_ptr(), write_onehot.data_ptr(),
            k_out.data_ptr(), v_out.data_ptr(), out.data_ptr(), b, h, beam, s, dh,
            _KIND[q.dtype], _build.stream_of(q),
        ),
        "beam_reorder_attend",
    )
    launched("beam_attend", "REORDER_LAUNCHES")
    return out, k_out, v_out
