"""SONAR text encoder: NLLB-style Transformer encoder + pooling.

Port of ``SonarTextEncoder.apply`` of ``sonar_tpu.models.sonar_text.model``:

- frontend: scaled embedding + legacy-offset sinusoidal PE (``_from_fairseq``
  grows the table by pad_idx + 1) or a learned table, then dropout when a
  ``generator`` is given (training),
- N pre-LN encoder layers; a trailing stack LN only when the config is
  ``normalize_before``,
- the model-level final LayerNorm,
- MEAN / MAX / LAST pooling, or the ATTENTION pooler (a small post- or
  pre-LN decoder attending from one BOS token, then a projection).

The parameters are an ``nn.Module`` tree that mirrors the JAX pytree key
for key (a sub-module per dict, a buffer per tensor, layers stacked on a
leading L axis), so ``state_dict()`` names follow the checkpoint layout.
``apply_packed`` encodes packed rows (``sonar_tpu_torch.data.packing``).
``remat=True`` recomputes each encoder layer in the backward pass.
"""

from __future__ import annotations

from typing import Callable, Optional

from sonar_tpu_torch.models.common import ParamTree, SonarEncoderOutput
from sonar_tpu_torch.models.sonar_text.config import SonarTextEncoderConfig
from sonar_tpu_torch.nn.core import Params, embedding_lookup, layer_norm
from sonar_tpu_torch.nn.frontend import EmbeddingFrontend
from sonar_tpu_torch.nn.pooling import Pooling, attention_pool, static_pool
from sonar_tpu_torch.nn.transformer import encoder_stack
from sonar_tpu_torch.ops.masks import additive_bias, length_mask
import torch
from torch import nn


class SonarTextEncoder(nn.Module):
    """``forward(seqs, seq_lens)`` -> ``SonarEncoderOutput``; ``forward_with``
    runs the same function on an explicit parameter tree (the counterpart of
    the JAX model's ``apply``)."""

    def __init__(self, config: SonarTextEncoderConfig, params: Params,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.remat = remat
        self.pooling = Pooling(config.pooling.lower())

        max_seq_len = config.max_seq_len
        if config._from_fairseq:
            assert config.vocab_info.pad_idx is not None
            max_seq_len += config.vocab_info.pad_idx + 1
        self.max_seq_len = max_seq_len
        # Longest token sequence the PE table serves: the legacy offset
        # (pad_idx + 1) takes the leading table rows.
        if config.no_token_positional_embeddings or config.learned_pos:
            self.max_source_len = max_seq_len
        else:
            self.max_source_len = max_seq_len - ((config.vocab_info.pad_idx or 0) + 1)
        self.frontend = EmbeddingFrontend(
            model_dim=config.model_dim,
            max_seq_len=max_seq_len,
            no_scale=config.no_scale_embedding,
            layernorm=config.layernorm_embedding,
            learned_pos=config.learned_pos,
            legacy_pad_idx=config.vocab_info.pad_idx,
            no_pos=config.no_token_positional_embeddings,
            dropout_p=config.emb_dropout_p,
            vocab_size=config.vocab_info.size,
        )
        if self.pooling == Pooling.ATTENTION:
            self.pooler_frontend = EmbeddingFrontend(
                model_dim=config.embedding_dim or config.model_dim, max_seq_len=1)
        self.params = ParamTree(params)

    def forward(self, seqs: torch.Tensor,
                seq_lens: Optional[torch.Tensor] = None) -> SonarEncoderOutput:
        return self.forward_with(self.params.tree(), seqs, seq_lens)

    def forward_with(self, params: Params, seqs: torch.Tensor,
                     seq_lens: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     stack_fn: Optional[Callable] = None) -> SonarEncoderOutput:
        """seqs: [B, S] int token ids; seq_lens: [B] or None; ``generator``
        turns the frontend's dropout on (training). The attention pooler's
        frontend gets none: the JAX model splits its key in two but passes
        the pooler neither half, so its pooler never drops.

        ``stack_fn(stacked_layer_params, x, bias) -> x`` replaces the layer
        stack when given: the seam ``parallel.pipeline`` plugs into."""
        cfg = self.config
        bias = None
        if seq_lens is not None:
            bias = additive_bias(length_mask(seq_lens, seqs.shape[1]))[:, None, None, :]
        x = self.frontend(params["encoder_frontend"], seqs, dtype=self.dtype,
                          generator=generator)
        if stack_fn is not None:
            x = stack_fn(params["encoder"]["layers"], x, bias)
        else:
            x = encoder_stack(
                params["encoder"]["layers"], x, bias,
                cfg.num_encoder_attn_heads, cfg.activation_fn, norm_order="pre",
                remat=self.remat,
            )
        if "layer_norm" in params["encoder"]:
            x = layer_norm(params["encoder"]["layer_norm"], x)
        encoded = layer_norm(params["layer_norm"], x)
        if self.pooling == Pooling.ATTENTION:
            embeddings = attention_pool(
                params["pooler"], self.pooler_frontend, encoded, seq_lens, bos_idx=0,
                num_heads=cfg.num_decoder_attn_heads, activation=cfg.activation_fn,
                norm_order="pre" if cfg.normalize_before else "post",
            )
        else:
            embeddings = static_pool(encoded, seq_lens, self.pooling)
        return SonarEncoderOutput(
            encoded_seqs=encoded, sentence_embeddings=embeddings, seq_lens=seq_lens
        )

    def apply_packed(self, params: Params, tokens: torch.Tensor, segment_ids: torch.Tensor,
                     positions: torch.Tensor, max_segments: int) -> torch.Tensor:
        """Packed forward (``sonar_tpu_torch.data.packing``): several
        sentences a row with block-diagonal attention, per-segment positions
        and per-segment mean pooling.

        tokens, segment_ids (0 = padding, 1..K = segments) and positions
        (restarting per segment) are [B, L] ints -> [B, max_segments, D]
        fp32; slot k holds segment k + 1, unfilled slots are zero. MEAN
        pooling and sinusoidal positions only, as in the JAX package.
        """
        cfg = self.config
        dtype = self.dtype
        if self.pooling != Pooling.MEAN:
            raise NotImplementedError("packed encoding supports MEAN pooling")
        if cfg.learned_pos or cfg.no_token_positional_embeddings:
            raise NotImplementedError("packed encoding needs sinusoidal PE")

        # Frontend with per-token positions (no layernorm_embedding, as in
        # the JAX package's packed forward).
        x = embedding_lookup(params["encoder_frontend"]["embed"], tokens, dtype=dtype,
                             vocab_size=cfg.vocab_info.size)
        if self.frontend.scale != 1.0:
            x = x * torch.tensor(self.frontend.scale, dtype=dtype)
        pe = self.frontend.pos_encoder
        x = x + pe.table(x.device, dtype)[positions.long() + pe.offset]

        # Block-diagonal attention within segments; a padding position
        # attends to no key.
        real = segment_ids > 0
        same = segment_ids[:, :, None] == segment_ids[:, None, :]
        bias = additive_bias(same & real[:, :, None] & real[:, None, :])[:, None, :, :]

        x = encoder_stack(params["encoder"]["layers"], x, bias,
                          cfg.num_encoder_attn_heads, cfg.activation_fn, norm_order="pre")
        if "layer_norm" in params["encoder"]:
            x = layer_norm(params["encoder"]["layer_norm"], x)
        encoded = layer_norm(params["layer_norm"], x)

        # Per-segment masked mean with the reference 1e-7 epsilon.
        slots = torch.arange(1, max_segments + 1, device=segment_ids.device)
        onehot = (segment_ids[..., None] == slots).float()  # [B, L, K]; padding: 0
        sums = torch.einsum("bld,blk->bkd", encoded.float(), onehot)
        counts = onehot.sum(dim=1)  # [B, K]
        return sums / (counts + 1e-7)[..., None]
