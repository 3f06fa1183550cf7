"""w2v-BERT Conformer blocks with Transformer-XL rel-pos attention
(``sonar_tpu.nn.conformer``).

block = x + 0.5 ffn1 -> x + rel-pos self-attention -> x + conv module ->
x + 0.5 ffn2 -> LayerNorm, every sub-block pre-LN, SiLU FFNs.

The rel-pos score uses the trig factorisation of the JAX package: the table
rows are sinusoids, so z . r(i - j) = w_i . basis_j with
w_i = [z_s sin(i w) + z_c cos(i w) | z_c sin(i w) - z_s cos(i w)] and
basis_j = [cos(j w) | sin(j w)], where z = (q_i + v_bias) r_proj per head
with r_proj's input columns de-interleaved (even table columns first).
bd is one product against the [S, D] basis; no [B, H, S, 2S - 1] table and
no rel-shift. That is the plain path's form (and the card's fp32 kernels');
the card's bf16 kernel computes the same bd in the rel-shift form, on the
distance table projected by r_proj per head ([H, 2S - 1, Dh], bf16) and
skewed inside each tile (``ops/cuda/relpos_flash.py``).

Dispatch is the JAX package's, on shapes: 128 <= S <= 2048, head dim 64 or
128 and a key-padding bias take ``relpos_flash_attention_v2`` (its wrapper
then runs the CUDA kernel for CUDA tensors, its plain version for CPU
tensors) unless autograd records, a ``no_cuda_kernels()`` scope is on or
``set_attention_impl("plain")`` was called (``ops.gates``); everything else
takes ``rel_pos_attend_plain``, the math of the JAX package's XLA lowering.
``PLAIN_CALLS`` counts the latter. The kernel reads r_proj per head
(``relpos_heads``), laid out from the layer's r_proj at each call, so a
trained r_proj is never read through a stale copy. ``conformer_stack(remat=
True)`` recomputes each block in the backward pass.

Each residual add and the LayerNorm after it are one call
(``ops.cuda.layer_norm``): five a block, the first an LN alone. A
contiguous CUDA x of a width the kernel takes (D a multiple of 256 up to
2048, bf16 or fp32) goes through ``add_layer_norm``, one launch each,
unless autograd records or a ``no_cuda_kernels()`` scope is on; otherwise
``add_layer_norm_plain`` runs the JAX block's expression as it stands.

Under a model split (``parallel.comm.model_parallel``) a rank runs its
H / model heads and its share of each half-FFN's columns, as in
``nn.transformer``; r_proj, u_bias and v_bias stay whole (as in the JAX
package) and the rank reads its heads' slices of them through *f*, so their
gradients sum the ranks' parts. The rel-pos kernel (#6) runs on the rank's
heads.
"""

from __future__ import annotations

from dataclasses import dataclass
import functools
import math
from typing import Callable, Optional, Tuple

import numpy as np
from sonar_tpu_torch.nn.core import Params, linear, row_linear
from sonar_tpu_torch.nn.transformer import _merge_heads, _split_heads, local_heads, run_layers
from sonar_tpu_torch.ops.attention import softmax
from sonar_tpu_torch.ops.cuda import layer_norm as aln
from sonar_tpu_torch.ops.gates import attention_impl, kernels_allowed
from sonar_tpu_torch.parallel.comm import Group, copy_to_group, model_group
import torch

PLAIN_CALLS = 0  # rel-pos attention calls outside the kernel gate


@dataclass(frozen=True)
class ConformerConfig:
    model_dim: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_inner_dim: int = 4096
    depthwise_kernel_size: int = 31
    dropout_p: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.model_dim // self.num_heads


# -- relative positions -------------------------------------------------------


def _rel_inv_freq(dim: int) -> np.ndarray:
    """fairseq2/ESPnet frequencies: exp(-2i ln(10000) / dim)."""
    return np.exp(np.arange(0, dim, 2, dtype=np.float64) * (-np.log(10000.0) / dim))


def rel_pos_table(seq_len: int, dim: int) -> torch.Tensor:
    """[2S - 1, D] fp32 encodings of distances S - 1 .. -(S - 1), with sin on
    the even and cos on the odd columns (the checkpoints' convention)."""
    positions = np.arange(seq_len - 1, -seq_len, -1, dtype=np.float64)
    args = positions[:, None] * _rel_inv_freq(dim)[None, :]
    table = np.zeros((positions.shape[0], dim))
    table[:, 0::2] = np.sin(args)
    table[:, 1::2] = np.cos(args)
    return torch.from_numpy(table.astype(np.float32))


def rel_pos_sin_cos_basis(seq_len: int, dim: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(si, ci, basis): the [S, D/2] sin/cos i-rotations and the [S, D]
    cos|sin j-basis of the factorisation, as fp32 numpy arrays."""
    args = np.arange(seq_len, dtype=np.float64)[:, None] * _rel_inv_freq(dim)[None, :]
    si = np.sin(args).astype(np.float32)
    ci = np.cos(args).astype(np.float32)
    return si, ci, np.concatenate([ci, si], axis=-1)


@functools.lru_cache(maxsize=64)
def _trig_tables(seq_len: int, dim: int, dtype: torch.dtype,
                 device: torch.device) -> Tuple[torch.Tensor, ...]:
    """``rel_pos_sin_cos_basis`` rounded to ``dtype`` on ``device``, made once
    per shape (every layer of a batch reads the same tables; read only).
    They are made outside inference mode even when an inference forward asks
    first: a training forward saves them for its backward, which an
    inference tensor refuses."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(t).to(device=device, dtype=dtype).contiguous()
                     for t in rel_pos_sin_cos_basis(seq_len, dim))


def _deinterleave(dim: int) -> torch.Tensor:
    return torch.from_numpy(np.concatenate([np.arange(0, dim, 2), np.arange(1, dim, 2)]))


def relpos_heads(r_proj_kernel: torch.Tensor, num_heads: int) -> torch.Tensor:
    """r_proj kernel [..., D, D] -> the kernel's per-head layout
    [..., H, D, Dh], input columns de-interleaved, contiguous."""
    *lead, d, _ = r_proj_kernel.shape
    w = r_proj_kernel.reshape(*lead, d, num_heads, d // num_heads).transpose(-3, -2)
    return w[..., _deinterleave(d).to(w.device), :].contiguous()


def _use_relpos_kernel(bias: Optional[torch.Tensor], s: int, hd: int) -> bool:
    """The JAX package's gate: the kernel reads a broadcastable [B, 1, 1, S]
    key mask only, and its shared-memory plan covers 128 <= S <= 2048;
    ``set_attention_impl("plain")`` turns it off."""
    if attention_impl() == "plain":
        return False
    if bias is not None and not (bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[-2] == 1):
        return False
    return 128 <= s <= 2048 and hd in (64, 128)


def rel_pos_qkv(params: Params, x: torch.Tensor, num_heads: int) -> Tuple[torch.Tensor, ...]:
    """[B, S, D] -> per-head q, k, v [B, H, S, Dh] (the rank's heads under a
    model split)."""
    group = model_group()
    x = copy_to_group(x, group)
    return tuple(_split_heads(linear(params[p], x), local_heads(num_heads, group))
                 for p in ("q_proj", "k_proj", "v_proj"))


def _rank_heads(t: torch.Tensor, dim: int, num_heads: int,
                group: Optional[Group]) -> torch.Tensor:
    """The rank's heads of a whole per-head tensor (axis ``dim`` holds the
    heads), read through *f*."""
    if group is None:
        return t
    h = local_heads(num_heads, group)
    return copy_to_group(t, group).narrow(dim, group.index * h, h)


def rel_pos_attend_plain(
    params: Params,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    si: torch.Tensor,
    ci: torch.Tensor,
    basis: torch.Tensor,
    bias: Optional[torch.Tensor],
    cfg: ConformerConfig,
) -> torch.Tensor:
    """The math of the JAX package's XLA lowering (``rel_pos_attend_xla``):
    z, w, bd and ac in the compute dtype (bf16 for bf16 models), the scaled
    scores in fp32, fp32 softmax, P rounded to the model dtype. -> the
    attention output [B, S, D] after ``output_proj``."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    d, h, hd = cfg.model_dim, cfg.num_heads, cfg.head_dim
    half = d // 2
    dt = q.dtype
    acc = torch.float32 if dt == torch.float32 else dt
    group = model_group()
    sdpa = params["sdpa"]
    u = _rank_heads(sdpa["u_bias"], 0, h, group).to(dt)
    vb = _rank_heads(sdpa["v_bias"], 0, h, group).to(dt)
    wr = sdpa["r_proj"]["kernel"].to(acc).reshape(d, h, hd)
    wr = _rank_heads(wr[_deinterleave(d).to(wr.device)], 1, h, group)  # [D, H, Dh]
    qv = (q + vb[None, :, None, :]).to(acc)
    z = torch.einsum("bhie,dhe->bhid", qv, wr)                           # [B, H, S, D]
    z_s, z_c = z[..., :half], z[..., half:]
    si, ci = si.to(acc), ci.to(acc)
    w = torch.cat([z_s * si + z_c * ci, z_c * si - z_s * ci], dim=-1)
    bd = w @ basis.to(acc).transpose(0, 1)                               # [B, H, S, S]
    ac = (q + u[None, :, None, :]) @ k.transpose(-1, -2)
    # The JAX lowering multiplies by a numpy float64 scale, which promotes
    # the bf16 sum to fp32: the scores and the mask bias are fp32.
    scores = (ac + bd).float() * (1.0 / math.sqrt(hd))
    if bias is not None:
        scores = scores + bias.float()
    probs = softmax(scores).to(dt)
    out = (probs.float() @ v.float()).to(dt)
    return row_linear(params["output_proj"], _merge_heads(out), group)


def rel_pos_attention(
    params: Params,
    x: torch.Tensor,
    bias: Optional[torch.Tensor],
    cfg: ConformerConfig,
) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D]: score(i, j) = (q_i + u) k_j + (q_i + v) r_(i-j),
    scaled by Dh^-0.5; ``bias`` broadcasts over [B, H, S, S]."""
    b, s, d = x.shape
    q, k, v = rel_pos_qkv(params, x, cfg.num_heads)
    sdpa = params["sdpa"]
    if (_use_relpos_kernel(bias, s, cfg.head_dim)
            and kernels_allowed(q, k, v, sdpa["u_bias"], sdpa["v_bias"],
                                sdpa["r_proj"]["kernel"])):
        from sonar_tpu_torch.ops.cuda.relpos_flash import relpos_flash_attention_v2

        group = model_group()
        h = cfg.num_heads
        si, ci, basis = _trig_tables(s, d, x.dtype, x.device)
        wr_heads = _rank_heads(relpos_heads(sdpa["r_proj"]["kernel"].to(x.dtype), h), 0, h,
                               group).contiguous()
        out = relpos_flash_attention_v2(
            q, k, v, wr_heads, si, ci, basis,
            _rank_heads(sdpa["u_bias"], 0, h, group).to(x.dtype).contiguous(),
            _rank_heads(sdpa["v_bias"], 0, h, group).to(x.dtype).contiguous(),
            None if bias is None else bias[:, 0, 0, :].float(),
        )
        return row_linear(params["output_proj"], _merge_heads(out), group)
    si, ci, basis = _trig_tables(s, d, torch.float32, x.device)
    return rel_pos_attend_plain(params, q, k, v, si, ci, basis, bias, cfg)


# -- convolution module --------------------------------------------------------


def conv_halo(params: Params) -> Tuple[int, int]:
    """The depthwise conv's frames of context before and after a frame:
    (K - 1) // 2 and the rest."""
    ksize = params["depthwise_conv"]["kernel"].shape[0]
    return (ksize - 1) // 2, ksize - 1 - (ksize - 1) // 2


def conv_module(params: Params, x: torch.Tensor, pad_mask: Optional[torch.Tensor],
                extend: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """[B, S, D] -> [B, S, D]: pointwise (2D) + GLU -> depthwise conv (groups
    D, zero padding (K - 1) // 2 before and the rest after) -> inference
    batch-norm in fp32 -> SiLU -> pointwise. Padded positions are zeroed
    first, so nothing leaks across the padding boundary. ``extend(y)``
    replaces the zero padding of the GLU's output [B, S, D] by the
    ``conv_halo`` frames it returns around y (``parallel.sequence``: the
    neighbouring shards' frames)."""
    if pad_mask is not None:
        x = torch.where(pad_mask[..., None], x, x.new_zeros(()))
    y = linear(params["pointwise_conv1"], x)
    a, g = y.chunk(2, dim=-1)
    y = a * torch.sigmoid(g)                                             # GLU
    kernel = params["depthwise_conv"]["kernel"].to(x.dtype)              # [K, 1, D]
    if extend is None:
        y = torch.nn.functional.pad(y.transpose(1, 2), conv_halo(params))
    else:
        y = extend(y).transpose(1, 2)
    y = torch.nn.functional.conv1d(y, kernel.permute(2, 1, 0), groups=y.shape[1])
    y = y.transpose(1, 2)
    bn = params["batch_norm"]
    # As the JAX module: fp32 statistics, with rsqrt(var + eps) in the
    # parameters' own dtype.
    y32 = (y.float() - bn["running_mean"]) * torch.rsqrt(bn["running_var"] + 1e-5)
    y = (y32 * bn["weight"] + bn["bias"]).to(x.dtype)
    y = y * torch.sigmoid(y)                                             # SiLU
    return linear(params["pointwise_conv2"], y)


# -- block and stack ---------------------------------------------------------------


def _half_ffn(params: Params, x: torch.Tensor) -> torch.Tensor:
    group = model_group()
    h = linear(params["inner_proj"], copy_to_group(x, group))
    return row_linear(params["output_proj"], h * torch.sigmoid(h), group)


_LAYER_NORMS = ("ffn1_layer_norm", "self_attn_layer_norm", "conv_layer_norm",
                "ffn2_layer_norm", "layer_norm")


def _use_add_ln_kernel(params: Params, x: torch.Tensor) -> bool:
    """Each residual add and the LayerNorm after it go to ``add_layer_norm``
    (one launch) for a contiguous CUDA x of a width and dtype the kernel
    takes, unless autograd records or a ``no_cuda_kernels()`` scope is on;
    otherwise the block runs the eager expression."""
    lns = [params[name] for name in _LAYER_NORMS]
    return (x.is_cuda and x.is_contiguous() and all(aln.kernel_takes(x, p) for p in lns)
            and kernels_allowed(x, *(t for p in lns for t in (p["weight"], p["bias"]))))


def conformer_block(
    params: Params,
    x: torch.Tensor,
    attn_bias: Optional[torch.Tensor],
    pad_mask: Optional[torch.Tensor],
    cfg: ConformerConfig,
) -> torch.Tensor:
    """x + 0.5 ffn1 -> + attention -> + conv -> + 0.5 ffn2 -> LayerNorm, each
    residual add fused with the LayerNorm that follows it: (x, h) =
    add_ln(x, branch(h)) is x + scale * branch(h) and the next sub-block's
    LN of that sum."""
    add_ln = aln.add_layer_norm if _use_add_ln_kernel(params, x) else aln.add_layer_norm_plain
    _, h = add_ln(x, None, params["ffn1_layer_norm"], want_sum=False)
    x, h = add_ln(x, _half_ffn(params["ffn1"], h), params["self_attn_layer_norm"], 0.5)
    x, h = add_ln(x, rel_pos_attention(params["self_attn"], h, attn_bias, cfg),
                  params["conv_layer_norm"])
    x, h = add_ln(x, conv_module(params["conv"], h, pad_mask), params["ffn2_layer_norm"])
    return add_ln(x, _half_ffn(params["ffn2"], h), params["layer_norm"], 0.5, want_sum=False)[1]


def conformer_stack(
    stacked: Params,
    x: torch.Tensor,
    attn_bias: Optional[torch.Tensor],
    pad_mask: Optional[torch.Tensor],
    cfg: ConformerConfig,
    remat: bool = False,
) -> torch.Tensor:
    """Run the L stacked Conformer blocks in order."""
    return run_layers(stacked, x, lambda p, h: conformer_block(p, h, attn_bias, pad_mask, cfg),
                      remat)
