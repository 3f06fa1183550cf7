"""SONAR speech encoder: w2v-BERT Conformer -> attention pooler -> 1024-d
(``sonar_tpu.models.sonar_speech.model``).

- frontend: fbank frames stacked by 2 (80 -> 160-d), cast to the model
  dtype, LayerNorm, projection to model_dim; ``seq_lens = frame_lens // 2``;
- the Conformer stack (``nn.conformer``), then the model-level LayerNorm;
- the attention pooler: a post-LN decoder (ReLU FFN) attending from the
  embedding of BOS (index 2) in a model_dim-row table, then an unbiased
  ``projection_out``.

Parameters are a ``ParamTree`` in the JAX pytree layout, Conformer layers
stacked on a leading L axis. ``remat=True`` recomputes each Conformer block
in the backward pass (training).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

from sonar_tpu_torch.models.common import ParamTree, SonarEncoderOutput
from sonar_tpu_torch.models.sonar_speech.config import SonarSpeechEncoderConfig
from sonar_tpu_torch.nn.conformer import conformer_stack
from sonar_tpu_torch.nn.core import Params, layer_norm, linear
from sonar_tpu_torch.nn.frontend import EmbeddingFrontend
from sonar_tpu_torch.nn.pooling import attention_pool
from sonar_tpu_torch.ops.masks import additive_bias, length_mask
import torch
from torch import nn


class SonarSpeechEncoder(nn.Module):
    """``forward(fbank, frame_lens)`` -> ``SonarEncoderOutput``;
    ``forward_with`` runs the same function on an explicit parameter tree
    (the counterpart of the JAX model's ``apply``)."""

    def __init__(self, config: SonarSpeechEncoderConfig, params: Params,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.remat = remat
        # The pooler's table has model_dim rows (a quirk of the checkpoints).
        self.pooler_frontend = EmbeddingFrontend(model_dim=config.model_dim,
                                                 max_seq_len=config.max_seq_len,
                                                 vocab_size=config.model_dim)
        self.params = ParamTree(params)

    def forward(self, fbank: torch.Tensor,
                frame_lens: Optional[torch.Tensor] = None) -> SonarEncoderOutput:
        return self.forward_with(self.params.tree(), fbank, frame_lens)

    def frontend(self, params: Params, fbank: torch.Tensor,
                 frame_lens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, T, C] fbank -> ([B, T // 2, model_dim], seq_lens)."""
        stride = self.config.frontend.fbank_stride
        b, t, c = fbank.shape
        t2 = t // stride
        x = fbank[:, : t2 * stride].reshape(b, t2, c * stride).to(self.dtype)
        x = layer_norm(params["post_extract_layer_norm"], x)
        x = linear(params["model_dim_proj"], x)
        return x, torch.div(frame_lens, stride, rounding_mode="floor")

    def forward_with(self, params: Params, fbank: torch.Tensor,
                     frame_lens: Optional[torch.Tensor] = None,
                     stack_fn: Optional[Callable] = None) -> SonarEncoderOutput:
        """fbank [B, T, num_mel] float; frame_lens [B] valid frame counts.

        ``stack_fn(stacked_layer_params, x, attn_bias, pad_mask) -> x``
        replaces the Conformer stack when given: the seam
        ``parallel.pipeline`` and ``parallel.sequence`` plug into."""
        cfg = self.config
        if frame_lens is None:
            frame_lens = torch.full((fbank.shape[0],), fbank.shape[1], dtype=torch.int32,
                                    device=fbank.device)
        x, seq_lens = self.frontend(params["encoder_frontend"], fbank, frame_lens)
        mask = length_mask(seq_lens, x.shape[1])
        bias = additive_bias(mask)[:, None, None, :]
        if stack_fn is not None:
            x = stack_fn(params["encoder"]["layers"], x, bias, mask)
        else:
            x = conformer_stack(params["encoder"]["layers"], x, bias, mask, cfg.conformer,
                                remat=self.remat)
        encoded = layer_norm(params["layer_norm"], x)
        pooled = attention_pool(
            params["encoder_pooler"], self.pooler_frontend, encoded, seq_lens,
            bos_idx=cfg.bos_idx, num_heads=cfg.num_decoder_attn_heads, activation="relu",
            norm_order=cfg.decoder_norm_order,
        )
        return SonarEncoderOutput(encoded_seqs=encoded, sentence_embeddings=pooled,
                                  seq_lens=seq_lens)
