"""SONAR text encoder: NLLB-style Transformer encoder + pooling.

Port of ``SonarTextEncoder.apply`` of ``sonar_tpu.models.sonar_text.model``:

- frontend: scaled embedding + legacy-offset sinusoidal PE (``_from_fairseq``
  grows the table by pad_idx + 1),
- N pre-LN encoder layers; a trailing stack LN only when the config is
  ``normalize_before``,
- the model-level final LayerNorm,
- MEAN / MAX / LAST pooling.

The parameters are an ``nn.Module`` tree that mirrors the JAX pytree key
for key (a sub-module per dict, a buffer per tensor, layers stacked on a
leading L axis), so ``state_dict()`` names follow the checkpoint layout.
``apply_packed`` and the ATTENTION pooler are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from sonar_tpu_torch.models.common import SonarEncoderOutput
from sonar_tpu_torch.models.sonar_text.config import SonarTextEncoderConfig
from sonar_tpu_torch.nn.core import Params, layer_norm
from sonar_tpu_torch.nn.frontend import EmbeddingFrontend
from sonar_tpu_torch.nn.pooling import Pooling, static_pool
from sonar_tpu_torch.nn.transformer import encoder_stack
from sonar_tpu_torch.ops.masks import additive_bias, length_mask
import torch
from torch import nn


class ParamTree(nn.Module):
    """A nested dict of tensors held as an ``nn.Module``: one sub-module per
    dict, one (persistent) buffer per tensor. ``tree()`` gives the dict back
    with the module's current tensors (after ``.to(device)`` too)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self._keys = list(tree)
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            else:
                self.register_buffer(key, value)

    def tree(self) -> Params:
        out: Params = {}
        for key in self._keys:
            value = getattr(self, key)
            out[key] = value.tree() if isinstance(value, ParamTree) else value
        return out


class SonarTextEncoder(nn.Module):
    """``forward(seqs, seq_lens)`` -> ``SonarEncoderOutput``; ``forward_with``
    runs the same function on an explicit parameter tree (the counterpart of
    the JAX model's ``apply``)."""

    def __init__(self, config: SonarTextEncoderConfig, params: Params,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.pooling = Pooling(config.pooling.lower())
        if self.pooling == Pooling.ATTENTION:
            raise NotImplementedError("the ATTENTION pooler is not ported yet")
        if config.learned_pos:
            raise NotImplementedError("learned positional embeddings are not ported")

        max_seq_len = config.max_seq_len
        if config._from_fairseq:
            assert config.vocab_info.pad_idx is not None
            max_seq_len += config.vocab_info.pad_idx + 1
        self.max_seq_len = max_seq_len
        # Longest token sequence the PE table serves: the legacy offset
        # (pad_idx + 1) takes the leading table rows.
        if config.no_token_positional_embeddings:
            self.max_source_len = max_seq_len
        else:
            self.max_source_len = max_seq_len - ((config.vocab_info.pad_idx or 0) + 1)
        self.frontend = EmbeddingFrontend(
            model_dim=config.model_dim,
            max_seq_len=max_seq_len,
            no_scale=config.no_scale_embedding,
            layernorm=config.layernorm_embedding,
            legacy_pad_idx=config.vocab_info.pad_idx,
            no_pos=config.no_token_positional_embeddings,
        )
        self.params = ParamTree(params)

    def forward(self, seqs: torch.Tensor,
                seq_lens: Optional[torch.Tensor] = None) -> SonarEncoderOutput:
        return self.forward_with(self.params.tree(), seqs, seq_lens)

    def forward_with(self, params: Params, seqs: torch.Tensor,
                     seq_lens: Optional[torch.Tensor] = None) -> SonarEncoderOutput:
        """seqs: [B, S] int token ids; seq_lens: [B] or None."""
        cfg = self.config
        bias = None
        if seq_lens is not None:
            bias = additive_bias(length_mask(seq_lens, seqs.shape[1]))[:, None, None, :]
        x = self.frontend(params["encoder_frontend"], seqs, dtype=self.dtype)
        x = encoder_stack(
            params["encoder"]["layers"], x, bias,
            cfg.num_encoder_attn_heads, cfg.activation_fn, norm_order="pre",
        )
        if "layer_norm" in params["encoder"]:
            x = layer_norm(params["encoder"]["layer_norm"], x)
        encoded = layer_norm(params["layer_norm"], x)
        embeddings = static_pool(encoded, seq_lens, self.pooling)
        return SonarEncoderOutput(
            encoded_seqs=encoded, sentence_embeddings=embeddings, seq_lens=seq_lens
        )
