"""Conformer rel-pos attention: the two entry points of the TPU kernel file.

Port of ``sonar_tpu/ops/pallas/relpos_flash.py``; the CUDA kernels are
``csrc/relpos_flash.cu``.

- ``relpos_flash_attention_v2`` (the Conformer's path) builds the positional
  term inside the kernel; with ac = (q + u) . k_j, score = (ac + bd) *
  Dh^-0.5 + key_bias. Its plain version (the CPU's) and the card's fp32
  kernels keep the TPU kernel's trig form: z = (q + v_bias) Wr_h^T, the
  i-rotation w = [z_s si + z_c ci | z_c si - z_s ci], and bd = w . basis_j.
  The card's bf16 kernel uses the rel-shift form on the projected distance
  table (``relpos_bd_shift_plain``): P[m] = T[m] Wr_h for m = -(S - 1) ..
  S - 1, rounded to bf16, and bd[i, j] = (q_i + v_bias) . P[i - j].
- ``relpos_flash_attention`` (v1) takes bd precomputed [B, H, S, S].

Both: fp32 softmax with a true division, P rounded to the value dtype, P V
accumulated in fp32. v2 rounds q + u, q + v_bias and w (bf16 kernel: the
table P) to the model dtype (the TPU kernel's casts); v1 keeps q + u in
fp32.

Masked keys carry ``finfo(float32).min`` in ``key_bias``; a row whose every
key is masked comes out as the uniform average of its S values. (The JAX
wrapper pads S to a multiple of 128 with masked zero keys, so its fully
masked rows average over the padded length; such rows are discarded.)
"""

from __future__ import annotations

import ctypes
from typing import Optional

from sonar_tpu_torch.ops import _build
from sonar_tpu_torch.ops.cuda import launched
from sonar_tpu_torch.ops.attention import softmax
from sonar_tpu_torch.ops.cuda.int8_blocks import check_cuda, require
import torch

LAUNCHES = 0      # relpos_flash_attention_v2 kernel launches
V1_LAUNCHES = 0   # relpos_flash_attention kernel launches
_KIND = {torch.float32: 0, torch.bfloat16: 1}
# fp32 v2's workspace (w and bd) is at most this large, or one batch row's:
# a larger batch is launched in chunks that fit. bf16 v2 takes none.
WORKSPACE_BYTES = 512 << 20
# Zero rows before the first distance of bf16 v2's table [H, 2S - 1 +
# TABLE_PAD, Dh] (``csrc/relpos_flash.cu``: RT_PAD).
TABLE_PAD = 128


def _tail(ac: torch.Tensor, bd: torch.Tensor, v: torch.Tensor,
          key_bias: Optional[torch.Tensor]) -> torch.Tensor:
    """(ac + bd) * scale + key bias -> softmax -> P (rounded to v's dtype) V."""
    scores = (ac + bd) * (v.shape[-1] ** -0.5)
    if key_bias is not None:
        scores = scores + key_bias.float()[:, None, None, :]
    p = softmax(scores).to(v.dtype).float()
    return (p @ v.float()).to(v.dtype)


def relpos_bd_plain(
    q: torch.Tensor, wr_heads: torch.Tensor, si: torch.Tensor, ci: torch.Tensor,
    basis: torch.Tensor, v_bias: torch.Tensor,
) -> torch.Tensor:
    """The v2 kernel's positional term bd [B, H, S, S] in fp32: z =
    round(q + v_bias) Wr_h^T, w = round(rotate(z)), bd = w . basis_j, every
    product in fp32 on values rounded where the kernel rounds them."""
    dt = q.dtype
    half = si.shape[-1]
    qv = (q.float() + v_bias.float()[None, :, None, :]).to(dt).float()
    z = torch.einsum("bhie,hde->bhid", qv, wr_heads.float())             # [B, H, S, D]
    z_s, z_c = z[..., :half], z[..., half:]
    si32, ci32 = si.float(), ci.float()
    w = torch.cat([z_s * si32 + z_c * ci32, z_c * si32 - z_s * ci32], dim=-1).to(dt)
    return w.float() @ basis.float().transpose(0, 1)


def relpos_bd_shift_plain(
    q: torch.Tensor, wr_heads: torch.Tensor, si: torch.Tensor, ci: torch.Tensor,
    v_bias: torch.Tensor,
) -> torch.Tensor:
    """bd [B, H, S, S] in fp32 in the rel-shift form of the card's bf16
    kernel: the distance table T[m] = [sin(m w) | cos(m w)] (Wr_h's
    de-interleaved column order) from si / ci by reflection (sin odd, cos
    even), P = T Wr_h [H, 2S - 1, Dh] rounded to the model dtype, and
    bd[i, j] = round(q_i + v_bias) . P[i - j]. Products in fp32."""
    dt = q.dtype
    s = si.shape[0]
    m = torch.arange(-(s - 1), s, device=q.device)
    sign = torch.where(m < 0, -1.0, 1.0)[:, None]
    table = torch.cat([si.float()[m.abs()] * sign, ci.float()[m.abs()]], dim=-1)  # [2S - 1, D]
    p = torch.einsum("md,hde->hme", table, wr_heads.float()).to(dt).float()
    qv = (q.float() + v_bias.float()[None, :, None, :]).to(dt).float()
    window = qv @ p.transpose(-1, -2)[None]                          # [B, H, S, 2S - 1]
    i = torch.arange(s, device=q.device)
    rel = (i[:, None] - i[None, :] + (s - 1)).expand(*window.shape[:2], s, s)
    return window.gather(-1, rel)


def relpos_flash_attention_v2_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    wr_heads: torch.Tensor, si: torch.Tensor, ci: torch.Tensor, basis: torch.Tensor,
    u_bias: torch.Tensor, v_bias: torch.Tensor,
    key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The v2 kernel's math in PyTorch (``relpos_bd_plain`` for bd, q + u
    rounded to the model dtype)."""
    bd = relpos_bd_plain(q, wr_heads, si, ci, basis, v_bias)
    qu = (q.float() + u_bias.float()[None, :, None, :]).to(q.dtype).float()
    return _tail(qu @ k.float().transpose(-1, -2), bd, v, key_bias)


def relpos_flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bd: torch.Tensor,
    u_bias: torch.Tensor, key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The v1 kernel's math: q + u and the products in fp32, bd upcast."""
    ac = (q.float() + u_bias.float()[None, :, None, :]) @ k.float().transpose(-1, -2)
    return _tail(ac, bd.float(), v, key_bias)


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, "q, k, v must be 4-D")
    b, h, s, dh = q.shape
    require(tuple(k.shape) == (b, h, s, dh) and tuple(v.shape) == (b, h, s, dh),
            f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not match q {tuple(q.shape)}")
    require(q.dtype in _KIND and k.dtype == q.dtype and v.dtype == q.dtype,
            "q, k, v must share one dtype, fp32 or bf16")
    require(dh in (64, 128), f"head dim {dh} not in (64, 128)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        require(t.device == q.device, f"{name} must be on {q.device}")
        require(t.stride(-1) == 1, f"{name} must have a unit last stride")
        # K rows are read as 16-byte vectors.
        require(all(st % 8 == 0 for st in t.stride()[:3]) and t.data_ptr() % 16 == 0,
                f"{name} must be 16-byte aligned with strides that are multiples of 8")
    return b, h, s, dh


def _key_bias(key_bias: Optional[torch.Tensor], b: int, s: int,
              device: torch.device) -> Optional[torch.Tensor]:
    if key_bias is None:
        return None
    require(tuple(key_bias.shape) == (b, s), f"key_bias must be [B, S] = {(b, s)}")
    key_bias = key_bias.float().contiguous()
    check_cuda("key_bias", key_bias, device)
    return key_bias


def _strides(*ts: torch.Tensor) -> list:
    return [st for t in ts for st in t.stride()[:3]]


def _workspace(b: int, h: int, s: int, d: int, device: torch.device) -> torch.Tensor:
    """fp32 v2's workspace (w and bd; float32 elements): as many batch rows
    as fit in WORKSPACE_BYTES (one at least), each of the size the kernel
    asks for."""
    per_batch = ctypes.c_longlong()
    _build.check(_build.library().sonar_relpos_v2_workspace(
        h, s, d, _KIND[torch.float32], ctypes.byref(per_batch)), "relpos_flash_attention_v2")
    rows = max(1, min(b, WORKSPACE_BYTES // per_batch.value))
    return torch.empty(rows * per_batch.value // 4, dtype=torch.float32, device=device)


def relpos_flash_attention_v2(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    wr_heads: torch.Tensor, si: torch.Tensor, ci: torch.Tensor, basis: torch.Tensor,
    u_bias: torch.Tensor, v_bias: torch.Tensor,
    key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q, k, v [B, H, S, Dh] (pre-bias; any strides with a unit last one);
    wr_heads [H, D, Dh]; si, ci [S, D/2]; basis [S, D]; u_bias, v_bias
    [H, Dh], all in the model dtype; key_bias [B, S] fp32 or None.
    -> [B, H, S, Dh]. In bf16: two launches (the distance table, then the
    attention), counted as one."""
    if not q.is_cuda:
        return relpos_flash_attention_v2_plain(q, k, v, wr_heads, si, ci, basis,
                                               u_bias, v_bias, key_bias)
    b, h, s, dh = _check_qkv(q, k, v)
    d = basis.shape[-1]
    require(d % 64 == 0, f"model dim {d} must be a multiple of 64")
    for name, t, shape in (("wr_heads", wr_heads, (h, d, dh)), ("si", si, (s, d // 2)),
                           ("ci", ci, (s, d // 2)), ("basis", basis, (s, d)),
                           ("u_bias", u_bias, (h, dh)), ("v_bias", v_bias, (h, dh))):
        check_cuda(name, t, q.device, dtype=q.dtype, shape=shape)
    key_bias = _key_bias(key_bias, b, s, q.device)
    out = torch.empty((b, h, s, dh), dtype=q.dtype, device=q.device)
    if q.dtype == torch.bfloat16:
        # The kernels read Wr_h, the trig tables and the biases as 16-byte vectors.
        require(all(t.data_ptr() % 16 == 0 for t in (wr_heads, si, ci, u_bias, v_bias)),
                "wr_heads, si, ci, u_bias and v_bias must be 16-byte aligned")
        scratch = torch.empty((h, 2 * s - 1 + TABLE_PAD, dh), dtype=q.dtype, device=q.device)
    else:
        scratch = _workspace(b, h, s, d, q.device)
    _build.check(
        _build.library().sonar_relpos_flash_v2(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), wr_heads.data_ptr(), si.data_ptr(),
            ci.data_ptr(), basis.data_ptr(), u_bias.data_ptr(), v_bias.data_ptr(),
            _build.ptr(key_bias), out.data_ptr(), scratch.data_ptr(),
            scratch.numel() * scratch.element_size(),
            b, h, s, dh, d,
            *_strides(q, k, v), _KIND[q.dtype], _build.stream_of(q),
        ),
        "relpos_flash_attention_v2",
    )
    launched("relpos_flash", "LAUNCHES")
    return out


def relpos_flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bd: torch.Tensor,
    u_bias: torch.Tensor, key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q, k, v [B, H, S, Dh]; bd [B, H, S, S] and u_bias [H, Dh] in q's
    dtype; key_bias [B, S] fp32 or None. -> [B, H, S, Dh]."""
    if not q.is_cuda:
        return relpos_flash_attention_plain(q, k, v, bd, u_bias, key_bias)
    b, h, s, dh = _check_qkv(q, k, v)
    check_cuda("bd", bd, q.device, dtype=q.dtype, shape=(b, h, s, s))
    check_cuda("u_bias", u_bias, q.device, dtype=q.dtype, shape=(h, dh))
    key_bias = _key_bias(key_bias, b, s, q.device)
    out = torch.empty((b, h, s, dh), dtype=q.dtype, device=q.device)
    _build.check(
        _build.library().sonar_relpos_flash_v1(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bd.data_ptr(), u_bias.data_ptr(),
            _build.ptr(key_bias), out.data_ptr(), b, h, s, dh,
            *_strides(q, k, v), _KIND[q.dtype], _build.stream_of(q),
        ),
        "relpos_flash_attention",
    )
    launched("relpos_flash", "V1_LAUNCHES")
    return out
