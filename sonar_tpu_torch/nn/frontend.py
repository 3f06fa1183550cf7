"""Transformer embedding frontend (``sonar_tpu.nn.frontend``).

Scaled token embedding (x sqrt(d) unless ``no_scale``) -> positional
encoding (sinusoidal, or learned) -> optional LayerNorm -> dropout (only when
a ``generator`` is given: training). ``vocab_size`` is the table's full row
count, by which a vocabulary-split table is known (``nn.core.embedding_lookup``).
"""

from __future__ import annotations

from typing import Optional

from sonar_tpu_torch.nn.core import Params, dropout, embedding_lookup, layer_norm
from sonar_tpu_torch.nn.position import LearnedPositionEncoder, SinusoidalPositionEncoder, Step
import torch


class EmbeddingFrontend:
    """Static parts of the frontend; parameters live in the tree:

    params = {"embed": {"weight": [V, D]}, "layer_norm": {...}?, "pos": {...}?}
    """

    def __init__(
        self,
        model_dim: int,
        max_seq_len: int,
        no_scale: bool = False,
        layernorm: bool = False,
        learned_pos: bool = False,
        legacy_pad_idx: Optional[int] = None,
        no_pos: bool = False,
        dropout_p: float = 0.1,
        vocab_size: Optional[int] = None,
    ):
        self.model_dim = model_dim
        self.vocab_size = vocab_size
        self.max_seq_len = max_seq_len
        self.scale = 1.0 if no_scale else float(model_dim) ** 0.5
        self.layernorm = layernorm
        self.dropout_p = dropout_p
        self.learned_pos = learned_pos
        if no_pos:
            self.pos_encoder = None
        elif learned_pos:
            self.pos_encoder = LearnedPositionEncoder(model_dim, max_seq_len)
        else:
            self.pos_encoder = SinusoidalPositionEncoder(
                model_dim, max_seq_len, legacy_pad_idx=legacy_pad_idx
            )

    def __call__(
        self, params: Params, seqs: torch.Tensor, dtype: torch.dtype = torch.float32,
        step: Step = 0, generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """seqs: [B, S] int token ids -> [B, S, D] embeddings; ``step`` is
        the position of the first token (incremental decoding: a host int,
        or the decoder cache's 0-d index tensor, ``nn.position``); dropout
        draws its mask from ``generator``."""
        x = embedding_lookup(params["embed"], seqs, dtype=dtype, vocab_size=self.vocab_size)
        if self.scale != 1.0:
            # Scale in the compute dtype, as the reference multiplies by a
            # dtype-typed scalar.
            x = x * torch.tensor(self.scale, dtype=dtype)
        if self.learned_pos:
            x = self.pos_encoder(params["pos"], x, step=step)
        elif self.pos_encoder is not None:
            x = self.pos_encoder(x, step=step)
        if self.layernorm:
            x = layer_norm(params["layer_norm"], x)
        return dropout(x, self.dropout_p, generator)
