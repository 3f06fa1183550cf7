"""Sequence parallelism for the Conformer speech encoder, over
``torch.distributed`` (``sonar_tpu.parallel.sequence``).

The time axis S is split over the mesh's ``seq`` axis (``make_seq_mesh``),
so a long clip spreads its work and its [B, H, S, S] scores over the ranks.
Each rank holds S/n frames of every block:

- the LayerNorms, the macaron FFNs, the pointwise convolutions and GLU and
  the batch-norm work frame by frame: local, no communication;
- rel-pos attention: q, k and v are projected locally, K and V gathered over
  ``seq`` and the rank's query rows attend over every key. The positional
  term needs the global sin/cos rotations of the local rows (the
  ``_trig_tables`` rows from ``seq_index * S/n``) against the whole
  j-basis: ``nn.conformer.rel_pos_attend_plain``, the math of JAX's SP path
  (``rel_pos_attend_xla``). The rel-pos kernel (#6) reads square q/k/v and
  one S for the tables, so a shard's S/n rows against S keys take the plain
  path;
- the depthwise convolution (K frames) exchanges a halo: each rank
  contributes its first (K - 1) - (K - 1) // 2 and last (K - 1) // 2 frames
  to one gather over ``seq``, reads the previous rank's last and the next
  rank's first frames, and convolves without padding. At the global ends the
  halo reads zero, as the zero padding of the one-device module (JAX's
  non-wrapping ``ppermute`` zero-fills it): the end ranks mask what they
  gathered instead of skipping the read, so the gather's backward runs on
  every rank. A shard shorter than the halo raises.

Every rank gets the global input and returns the global output. The
gathers of K, V and the halo sum their gradient over ``seq`` before taking
the rank's slice; every leaf is shared by all the ranks, which sum their
partial gradients (``parallel.comm``). The result matches the one-device
stack to float-association noise (the products run at other shapes).
JAX's memoized programs have no counterpart.
"""

from __future__ import annotations

from typing import Any, Optional

from sonar_tpu_torch.models.common import SonarEncoderOutput
from sonar_tpu_torch.nn.conformer import (
    ConformerConfig,
    _half_ffn,
    _trig_tables,
    conformer_stack,
    conv_halo,
    conv_module,
    rel_pos_attend_plain,
    rel_pos_qkv,
)
from sonar_tpu_torch.nn.core import Params, layer_norm
from sonar_tpu_torch.nn.transformer import run_layers
from sonar_tpu_torch.parallel.comm import Group, gather_blocks, take_block
from sonar_tpu_torch.parallel.mesh import Mesh, expect_axis, make_axis_mesh
from sonar_tpu_torch.parallel.pipeline import encode_over_data, over_data, shared_leaves
import torch

__all__ = [
    "make_seq_mesh",
    "sequence_conformer_stack",
    "sequence_speech_encode",
]

Tensor = torch.Tensor


def make_seq_mesh(seq: int, data: int = -1) -> Mesh:
    """The (data, seq) mesh over the process group. Every rank must call it,
    in the same order as its other group creations."""
    return make_axis_mesh("seq", seq, data)


def _sp_conv_module(params: Params, x: Tensor, pad_mask: Optional[Tensor],
                    group: Group) -> Tensor:
    """The Conformer conv module on a shard of frames: pointwise parts
    local, the depthwise convolution over the shard extended by the
    neighbours' frames."""
    before, after = conv_halo(params)
    i, n = group.index, group.size

    def extend(y: Tensor) -> Tensor:
        s = y.shape[1]
        edges = torch.cat([y[:, :after], y[:, s - before:]], dim=1)
        both = gather_blocks(edges[None], group, 0, sum_grad=True)  # [n, B, after + before, D]
        zero = y.new_zeros(())
        left = torch.where(torch.tensor(i > 0, device=y.device),
                           both[(i - 1) % n][:, after:], zero)
        right = torch.where(torch.tensor(i < n - 1, device=y.device),
                            both[(i + 1) % n][:, :after], zero)
        return torch.cat([left, y, right], dim=1)

    return conv_module(params, x, pad_mask, extend)


def _sp_block(params: Params, x: Tensor, attn_bias: Optional[Tensor],
              pad_mask: Optional[Tensor], si: Tensor, ci: Tensor, basis: Tensor,
              cfg: ConformerConfig, group: Group) -> Tensor:
    x = x + 0.5 * _half_ffn(params["ffn1"], layer_norm(params["ffn1_layer_norm"], x))
    h = layer_norm(params["self_attn_layer_norm"], x)
    q, k, v = rel_pos_qkv(params["self_attn"], h, cfg.num_heads)
    k = gather_blocks(k, group, 2, sum_grad=True)                          # [B, H, S, Dh]
    v = gather_blocks(v, group, 2, sum_grad=True)
    x = x + rel_pos_attend_plain(params["self_attn"], q, k, v, si, ci, basis, attn_bias, cfg)
    x = x + _sp_conv_module(params["conv"], layer_norm(params["conv_layer_norm"], x), pad_mask,
                            group)
    x = x + 0.5 * _half_ffn(params["ffn2"], layer_norm(params["ffn2_layer_norm"], x))
    return layer_norm(params["layer_norm"], x)


def _check(x: Tensor, attn_bias: Optional[Tensor], cfg: ConformerConfig, n: int) -> None:
    """JAX's refusals, and a shard shorter than the halo."""
    s = x.shape[1]
    if s % n:
        raise ValueError(f"seq len {s} not divisible by seq-axis size {n}")
    if attn_bias is not None and not (
            attn_bias.dim() == 4 and attn_bias.shape[1] == 1 and attn_bias.shape[-2] == 1):
        raise ValueError("sequence parallelism needs a [B, 1, 1, S] key bias")
    halo = cfg.depthwise_kernel_size - 1 - (cfg.depthwise_kernel_size - 1) // 2
    if s // n < halo:
        raise ValueError(f"a shard of {s // n} frames is shorter than the depthwise "
                         f"convolution's halo of {halo} (kernel {cfg.depthwise_kernel_size})")


def _sp_rows(stacked: Params, x: Tensor, attn_bias: Optional[Tensor],
             pad_mask: Optional[Tensor], cfg: ConformerConfig, mesh: Mesh) -> Tensor:
    """The stack on a data row's rows: frames split over ``seq``, the output
    gathered whole on every rank of the row."""
    group = mesh.model_group
    s = x.shape[1]
    per = s // group.size
    si, ci, basis = _trig_tables(s, cfg.model_dim, torch.float32, x.device)
    si, ci = si.narrow(0, group.index * per, per), ci.narrow(0, group.index * per, per)
    mask = None if pad_mask is None else take_block(pad_mask, group, 1)
    y = run_layers(shared_leaves(stacked, group), take_block(x, group, 1),
                   lambda p, h: _sp_block(p, h, attn_bias, mask, si, ci, basis, cfg, group))
    return gather_blocks(y, group, 1)


def sequence_conformer_stack(stacked_params: Params, x: Tensor, attn_bias: Optional[Tensor],
                             pad_mask: Optional[Tensor], cfg: ConformerConfig,
                             mesh: Mesh) -> Tensor:
    """``conformer_stack`` with the time axis split over the mesh's ``seq``
    axis. S must divide by the ``seq`` size, a shard hold at least the
    depthwise convolution's halo, and the batch divide by ``data``;
    ``attn_bias`` must be a [B, 1, 1, S] key mask (the only form the speech
    model makes). Every rank passes the global x [B, S, D] and gets the
    global output."""
    expect_axis(mesh, "seq")
    n = mesh.shape["seq"]
    if n == 1:
        return conformer_stack(stacked_params, x, attn_bias, pad_mask, cfg)
    _check(x, attn_bias, cfg, n)
    (y,) = over_data(mesh, lambda p, xx, b, mk: (_sp_rows(p, xx, b, mk, cfg, mesh),),
                     stacked_params, x, attn_bias, pad_mask)
    return y


def sequence_speech_encode(model: Any, params: Params, fbank: Tensor,
                           frame_lens: Optional[Tensor] = None, *,
                           mesh: Mesh) -> SonarEncoderOutput:
    """A ``SonarSpeechEncoder``'s output with its Conformer stack
    sequence-split over the mesh's ``seq`` axis; the frontend, the LayerNorm
    and the attention pooler run on the rank's data rows. Every rank passes
    the global batch and gets the whole ``SonarEncoderOutput``."""
    expect_axis(mesh, "seq")
    cfg = model.config.conformer
    n = mesh.shape["seq"]

    def stack_fn(stacked: Params, x: Tensor, bias: Optional[Tensor],
                 mask: Optional[Tensor]) -> Tensor:
        if n == 1:
            return conformer_stack(stacked, x, bias, mask, cfg)
        _check(x, bias, cfg, n)
        return _sp_rows(stacked, x, bias, mask, cfg, mesh)

    return encode_over_data(mesh, model, params, fbank, frame_lens, stack_fn)
