"""Embedding-conditioned Transformer decoder (the SONAR text decoder).

Port of ``sonar_tpu.nn.conditional_decoder.ConditionalTransformerDecoder``:

- the "encoder output" is a length-1 memory holding one sentence embedding,
- pre-LN decoder layers with a final stack LayerNorm,
- the output projection is tied to the input embedding: logits = h @ E^T,
  accumulated and returned in fp32. Under a model split with a
  vocabulary-split table each rank computes its vocabulary block, and the
  blocks are gathered over the model group before anything reads them (the
  softmax, the beam top-k, the sampler), so the logits are exact.

``decode`` / ``forward`` run the full sequence (teacher-forced scoring) on
the module's parameters, ``decode_with`` / ``forward_with`` on an explicit
tree (training: gradients with respect to it, dropout from a ``generator``,
``remat``); ``init_cache`` / ``step`` run one position at a time against a
``DecoderCache`` for the generators. The parameters are an ``nn.Module``
tree in the JAX layout, as in ``SonarTextEncoder``.
"""

from __future__ import annotations

from typing import Optional, Tuple

from sonar_tpu_torch.models.common import ParamTree
from sonar_tpu_torch.models.sonar_text.config import SonarTextDecoderConfig
from sonar_tpu_torch.nn.core import Params, layer_norm
from sonar_tpu_torch.nn.frontend import EmbeddingFrontend
from sonar_tpu_torch.nn.transformer import (
    DecoderCache,
    decoder_stack,
    decoder_step,
    init_decoder_cache,
)
from sonar_tpu_torch.ops.masks import additive_bias, length_mask
from sonar_tpu_torch.ops.precision import matmul_f32_out
from sonar_tpu_torch.parallel.comm import copy_to_group, model_group, sum_over_group
import torch
from torch import nn


def tied_projection(h: torch.Tensor, embed: torch.Tensor,
                    vocab_size: Optional[int] = None) -> torch.Tensor:
    """[..., D] x [V, D] -> [..., V] fp32 logits: the model-dtype operands'
    products summed in fp32 (the JAX einsum's ``preferred_element_type``).

    Under a model split, an ``embed`` of fewer than ``vocab_size`` rows is
    the rank's vocabulary block: its logits are placed in a row of -0.0 at
    the block's offset and summed over the model group (*g*), which is the
    gather, exact to the bit; *f* sums the gradient of ``h``."""
    group = model_group()
    split = group is not None and vocab_size is not None and embed.shape[0] < vocab_size
    if split:
        h = copy_to_group(h, group)
    embed = embed.to(h.dtype)
    out = matmul_f32_out(h.reshape(-1, h.shape[-1]), embed.t())
    out = out.reshape(*h.shape[:-1], embed.shape[0])
    if split:
        lo = group.index * embed.shape[0]
        out = torch.nn.functional.pad(out, (lo, vocab_size - lo - embed.shape[0]), value=-0.0)
        out = sum_over_group(out, group)
    return out


class ConditionalTransformerDecoder(nn.Module):
    def __init__(self, config: SonarTextDecoderConfig, params: Params,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.remat = remat
        self.frontend = EmbeddingFrontend(
            model_dim=config.model_dim,
            max_seq_len=config.max_seq_len,
            no_scale=config.no_scale_embedding,
            layernorm=config.layernorm_embedding,
            learned_pos=config.learned_pos,
            legacy_pad_idx=config.vocab_info.pad_idx,
            no_pos=config.no_token_positional_embeddings,
            dropout_p=config.emb_dropout_p,
            vocab_size=config.vocab_info.size,
        )
        # Usable generation length given the legacy position offset.
        pad_off = (config.vocab_info.pad_idx or 0) + 1
        self.max_target_len = config.max_seq_len - (
            0 if config.no_token_positional_embeddings or config.learned_pos else pad_off
        )
        self.params = ParamTree(params)

    @property
    def device(self) -> torch.device:
        return self.params.decoder_frontend.embed.weight.device

    # -- full sequence ------------------------------------------------------

    def decode(self, seqs: torch.Tensor, seq_lens: Optional[torch.Tensor],
               memory: torch.Tensor, memory_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Teacher-forced decode: [B, S] ids + [B, S_mem, D_in] memory -> [B, S, D]."""
        return self.decode_with(self.params.tree(), seqs, seq_lens, memory, memory_lens)

    def decode_with(self, params: Params, seqs: torch.Tensor, seq_lens: Optional[torch.Tensor],
                    memory: torch.Tensor, memory_lens: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``decode`` on the tree ``params``; ``generator`` turns the
        frontend's dropout on (training)."""
        cfg = self.config
        s = seqs.shape[1]
        pos = torch.arange(s, device=seqs.device)
        mask = (pos[None, :] <= pos[:, None])[None, None]          # causal [1, 1, S, S]
        if seq_lens is not None:
            mask = mask & length_mask(seq_lens, s)[:, None, None, :]
        self_bias = additive_bias(mask)
        memory_bias = None
        if memory_lens is not None:
            memory_bias = additive_bias(length_mask(memory_lens, memory.shape[1]))[:, None, None, :]
        x = self.frontend(params["decoder_frontend"], seqs, dtype=self.dtype,
                          generator=generator)
        x = decoder_stack(params["decoder"]["layers"], x, self_bias, memory.to(self.dtype),
                          memory_bias, cfg.num_encoder_attn_heads, cfg.activation_fn,
                          norm_order="pre", remat=self.remat)
        return layer_norm(params["decoder"]["layer_norm"], x)

    def project(self, decoder_out: torch.Tensor) -> torch.Tensor:
        """Tied projection: logits = h @ E^T in fp32."""
        return tied_projection(decoder_out, self.params.decoder_frontend.embed.weight,
                               self.config.vocab_info.size)

    def forward(self, seqs: torch.Tensor, seq_lens: Optional[torch.Tensor],
                memory: torch.Tensor, memory_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """decode + project -> [B, S, V] fp32 logits."""
        return self.forward_with(self.params.tree(), seqs, seq_lens, memory, memory_lens)

    def forward_with(self, params: Params, seqs: torch.Tensor, seq_lens: Optional[torch.Tensor],
                     memory: torch.Tensor, memory_lens: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``forward`` on the tree ``params`` (the counterpart of the JAX
        model's ``forward``): the projection reads its tied embedding."""
        h = self.decode_with(params, seqs, seq_lens, memory, memory_lens, generator)
        return tied_projection(h, params["decoder_frontend"]["embed"]["weight"],
                               self.config.vocab_info.size)

    # -- incremental --------------------------------------------------------

    def init_cache(self, memory: torch.Tensor, max_len: int,
                   beam_size: Optional[int] = None) -> DecoderCache:
        cfg = self.config
        return init_decoder_cache(
            self.params.tree()["decoder"]["layers"], memory.to(self.dtype),
            cfg.num_encoder_attn_heads, max_len, memory.shape[0], cfg.model_dim, self.dtype,
            beam_size=beam_size,
        )

    def step(self, tokens: torch.Tensor, cache: DecoderCache,
             memory_bias: Optional[torch.Tensor] = None,
             ancestry: Optional[torch.Tensor] = None,
             beam_size: Optional[int] = None) -> Tuple[torch.Tensor, DecoderCache]:
        """One decode step: tokens [B] at position cache.index (a 0-d device
        tensor, which the frontend's position encoder and the cache write
        read on the device) -> ([B, V] fp32 logits, the cache advanced in
        place). ``ancestry`` / ``beam_size`` select beam mode
        (``nn.transformer.decoder_step``)."""
        params = self.params.tree()
        cfg = self.config
        x = self.frontend(params["decoder_frontend"], tokens[:, None], dtype=self.dtype,
                          step=cache.index)
        x, cache = decoder_step(params["decoder"]["layers"], x, cache, memory_bias,
                                cfg.num_encoder_attn_heads, cfg.activation_fn,
                                ancestry=ancestry, beam_size=beam_size)
        x = layer_norm(params["decoder"]["layer_norm"], x)
        return self.project(x)[:, 0], cache
