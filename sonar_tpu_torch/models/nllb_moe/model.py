"""NLLB-200 MoE: the encoder-decoder translation model with sparse FFNs.

The layer equations of HF's ``NllbMoe`` and fairseq's ``moe_freq`` transformer:

- one embedding table [V, D], scaled by sqrt(D), shared by the encoder and
  the decoder and tied to the output projection (logits = h @ E^T in fp32);
- fairseq sinusoidal positions read from row t + pad_idx + 1
  (``nn.position``);
- pre-LN layers, x + attn(LN(x)), then (decoder) x + cross_attn(LN(x),
  memory), then x + ffn(LN(x)), the FFN dense or, in every
  ``*_sparse_step``-th layer, the held experts' part of the top-2 expert
  layer (``nn.moe``);
- a final LayerNorm a stack.

Parameters (the JAX package's layout: linear kernels [in, out], the layers
of a group stacked on a leading axis)::

    {"embed": {"weight": [V, D]},
     "encoder": {"layers": dense, "sparse_layers": sparse, "layer_norm": LN},
     "decoder": {"layers": dense, "sparse_layers": sparse, "layer_norm": LN}}

A stack walks its two groups in the published order (``nn.transformer.
layer_plan``). ``encode`` returns the [B, S, D] memory; ``decode`` /
``forward`` run the decoder teacher-forced over a sequence memory and its
lengths; ``init_cache`` / ``step`` run it one position at a time for the
generators (``generation.decoder_runtime.TorchTextDecoder`` runs this model
as it runs the SONAR decoder).

The model owns the expert counters (``expert_rows``, ``expert_hits``: one
row a sparse layer, the encoder's first), device
tensors that the sparse layers add to inside the captured beam loop too;
``read_counters`` copies them out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
from sonar_tpu_torch.models.common import ParamTree
from sonar_tpu_torch.models.nllb_moe.config import NllbMoeConfig
from sonar_tpu_torch.nn.conditional_decoder import tied_projection
from sonar_tpu_torch.nn.core import Params, layer_norm
from sonar_tpu_torch.nn.frontend import EmbeddingFrontend
from sonar_tpu_torch.nn.transformer import (
    DecoderCache,
    decoder_stack,
    decoder_step,
    encoder_stack,
    init_decoder_cache,
    layer_plan,
    planned_layers,
)
from sonar_tpu_torch.ops.masks import additive_bias, length_mask
import torch
from torch import nn

SIDES = ("encoder", "decoder")


@dataclass
class SequenceMemory:
    """An encoder's output for the decoder: ``seqs`` [B, S, D] and the
    source lengths ``lens`` [B] (on the device, or on the host)."""

    seqs: Any
    lens: Any


class NllbMoeModel(nn.Module):
    def __init__(self, config: NllbMoeConfig, params: Params,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        pad = config.vocab_info.pad_idx or 0
        self.frontend = EmbeddingFrontend(
            model_dim=config.model_dim, max_seq_len=config.max_seq_len + pad + 1,
            legacy_pad_idx=pad, vocab_size=config.vocab_info.size)
        self.max_source_len = self.max_target_len = config.max_seq_len
        self.plans = {
            "encoder": layer_plan(config.num_encoder_layers, config.encoder_sparse_step),
            "decoder": layer_plan(config.num_decoder_layers, config.decoder_sparse_step),
        }
        n_sparse = sum(s for side in SIDES for s, _ in self.plans[side])
        held = config.held[1] - config.held[0]
        self.register_buffer("expert_rows", torch.zeros((n_sparse, held), dtype=torch.long),
                             persistent=False)
        self.register_buffer("expert_hits", torch.zeros((n_sparse, held), dtype=torch.long),
                             persistent=False)
        self.params = ParamTree(params)

    @property
    def device(self) -> torch.device:
        return self.params.embed.weight.device

    def sparse_rows(self, side: str) -> range:
        """The counters' rows of ``side``'s sparse layers."""
        n_enc = sum(s for s, _ in self.plans["encoder"])
        n_dec = sum(s for s, _ in self.plans["decoder"])
        return range(0, n_enc) if side == "encoder" else range(n_enc, n_enc + n_dec)

    def layers(self, params: Params, side: str) -> List[Params]:
        """``side``'s layer trees in the published order, each sparse layer's
        FFN given its row of the counters."""
        stack = params[side]
        out = planned_layers(stack["layers"], stack.get("sparse_layers"), self.plans[side])
        rows = iter(self.sparse_rows(side))
        for i, (sparse, _) in enumerate(self.plans[side]):
            if sparse:
                r = next(rows)
                out[i] = dict(out[i], ffn=dict(out[i]["ffn"], rows=self.expert_rows[r],
                                                hits=self.expert_hits[r]))
        return out

    def _embed(self, params: Params, seqs: torch.Tensor, step: Any = 0) -> torch.Tensor:
        return self.frontend({"embed": params["embed"]}, seqs, dtype=self.dtype, step=step)

    # -- encoder --------------------------------------------------------------

    def encode(self, seqs: torch.Tensor, seq_lens: Optional[torch.Tensor]) -> torch.Tensor:
        """[B, S] source ids, [B] lengths -> [B, S, D] memory (model dtype)."""
        params = self.params.tree()
        cfg = self.config
        bias = mask = None
        if seq_lens is not None:
            mask = length_mask(seq_lens, seqs.shape[1])
            bias = additive_bias(mask)[:, None, None, :]
        x = self._embed(params, seqs)
        x = encoder_stack(self.layers(params, "encoder"), x, bias, cfg.num_encoder_attn_heads,
                          cfg.activation_fn, token_mask=mask)
        return layer_norm(params["encoder"]["layer_norm"], x)

    # -- decoder, full sequence ----------------------------------------------

    def decode(self, seqs: torch.Tensor, seq_lens: Optional[torch.Tensor],
               memory: torch.Tensor, memory_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Teacher-forced: [B, S] ids over a [B, S_mem, D] memory -> [B, S, D]."""
        params = self.params.tree()
        cfg = self.config
        s = seqs.shape[1]
        pos = torch.arange(s, device=seqs.device)
        mask = (pos[None, :] <= pos[:, None])[None, None]
        tokens = None
        if seq_lens is not None:
            tokens = length_mask(seq_lens, s)
            mask = mask & tokens[:, None, None, :]
        memory_bias = None
        if memory_lens is not None:
            memory_bias = additive_bias(length_mask(memory_lens, memory.shape[1]))[:, None, None, :]
        x = self._embed(params, seqs)
        x = decoder_stack(self.layers(params, "decoder"), x, additive_bias(mask),
                          memory.to(self.dtype), memory_bias, cfg.num_decoder_attn_heads,
                          cfg.activation_fn, token_mask=tokens)
        return layer_norm(params["decoder"]["layer_norm"], x)

    def project(self, h: torch.Tensor) -> torch.Tensor:
        """Tied projection: logits = h @ E^T in fp32."""
        return tied_projection(h, self.params.embed.weight, self.config.vocab_info.size)

    def forward(self, seqs: torch.Tensor, seq_lens: Optional[torch.Tensor],
                memory: torch.Tensor, memory_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """decode + project -> [B, S, V] fp32 logits."""
        return self.project(self.decode(seqs, seq_lens, memory, memory_lens))

    # -- decoder, incremental ------------------------------------------------

    def init_cache(self, memory: torch.Tensor, max_len: int, beam_size: Optional[int] = None,
                   memory_lens: Optional[torch.Tensor] = None) -> DecoderCache:
        """The cache of a decode over ``memory`` [B, S_mem, D]: in beam mode
        one row a sentence, whose source K/V are kept once for its beams."""
        cfg = self.config
        rows = memory.shape[0] * (beam_size or 1)
        return init_decoder_cache(
            self.layers(self.params.tree(), "decoder"), memory.to(self.dtype),
            cfg.num_decoder_attn_heads, max_len, rows, cfg.model_dim, self.dtype,
            beam_size=beam_size, memory_lens=memory_lens)

    def step(self, tokens: torch.Tensor, cache: DecoderCache,
             memory_bias: Optional[torch.Tensor] = None,
             ancestry: Optional[torch.Tensor] = None,
             beam_size: Optional[int] = None) -> Tuple[torch.Tensor, DecoderCache]:
        """One decode step: tokens [B] at ``cache.index`` -> ([B, V] fp32
        logits, the cache advanced in place)."""
        params = self.params.tree()
        cfg = self.config
        x = self._embed(params, tokens[:, None], step=cache.index)
        x, cache = decoder_step(self.layers(params, "decoder"), x, cache, memory_bias,
                                cfg.num_decoder_attn_heads, cfg.activation_fn,
                                ancestry=ancestry, beam_size=beam_size)
        x = layer_norm(params["decoder"]["layer_norm"], x)
        return self.project(x)[:, 0], cache

    # -- counters -------------------------------------------------------------

    def read_counters(self) -> Dict[str, np.ndarray]:
        """The expert counters on the host (one copy: a sync with the
        device): ``rows`` and ``hits`` [sparse layers, E_h]."""
        both = torch.cat([self.expert_rows, self.expert_hits], dim=1).cpu().numpy()
        held = self.expert_rows.shape[1]
        return {"rows": both[:, :held], "hits": both[:, held:]}
