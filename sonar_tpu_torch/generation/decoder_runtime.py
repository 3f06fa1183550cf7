"""The conditional text decoder bound for generation on one device.

``TorchTextDecoder`` is the counterpart of ``JitTextDecoder``
(``sonar_tpu.generation.decoder_runtime``): teacher-forced ``score``,
beam-search ``generate_beam`` and top-p / top-k ``generate_sample``, in
floating point or, with ``quantize=True``, with int8 weights. PyTorch runs
eagerly, so there is no program per shape and the batch is decoded as
given, without the JAX package's power-of-two padding, unless its rows are
split over a mesh's ``data`` axis: then, as in the JAX runtime, the batch is
padded to a power of two and to a multiple of ``data``. Over a mesh each
rank decodes its data coordinate's rows with its share of the heads (and
vocabulary), every rank takes the same number of steps (the exit test is
agreed across the world), and the rows are gathered over the data group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
from sonar_tpu_torch.data.collate import round_up_pow2
from sonar_tpu_torch.device import resolve_device
from sonar_tpu_torch.generation.beam_search import BeamSearchConfig, beam_search_lax
from sonar_tpu_torch.generation.sampling import gumbel, sample_lax
from sonar_tpu_torch.nn.conditional_decoder import ConditionalTransformerDecoder
from sonar_tpu_torch.ops.precision import matmul_precision_for
from sonar_tpu_torch.parallel.comm import any_over, gather_blocks, model_parallel
from sonar_tpu_torch.parallel.mesh import (
    SINGLE_MESH,
    Mesh,
    data_sharding,
    pad_rows,
    shard_params,
)
import torch


class TorchTextDecoder:
    """A ``ConditionalTransformerDecoder`` on one device (``device=None``
    means the GPU). ``decode_steps`` counts the decoder steps run (prefix
    steps included), each of which goes through every layer once.

    ``quantize`` stores every projection of the decoder layers as int8 with
    per-output-channel scales (a runtime copy; ``nn.core.linear`` then runs
    them with dynamic per-row activation scales); the tied output
    projection stays in floating point. It is off by default, as in the JAX
    package, where int8 decode waits for validation on the published
    checkpoints (``INT8_DECODE_VALIDATED``).

    ``mesh`` (a ``parallel.mesh.Mesh``; ``SINGLE_MESH``, this process
    alone, when None) holds this rank's slice of the weights
    (``shard_params``); every rank takes the global batch and
    returns the whole result (see the module docstring).
    """

    def __init__(self, model: ConditionalTransformerDecoder, quantize: bool = False,
                 device: Any = None, mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.mesh = SINGLE_MESH if mesh is None else mesh
        params = model.params.tree()
        if quantize:
            # The JAX runtime quantizes the checkpoint layout as it is (the
            # decoder fuses no projections), and so does the port.
            from sonar_tpu_torch.ops.quantization import quantize_params_int8

            params = quantize_params_int8(params)
        params = shard_params(params, self.mesh)
        self.model = ConditionalTransformerDecoder(
            model.config, params, dtype=model.dtype
        ).to(self.device)
        self.decode_steps = 0

    @property
    def dtype(self) -> torch.dtype:
        return self.model.dtype

    @property
    def max_target_len(self) -> int:
        return self.model.max_target_len

    @property
    def vocab_info(self) -> Any:
        return self.model.config.vocab_info

    def _tensor(self, x: Any, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=dtype).to(self.device)

    def _rows(self, x: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """This rank's rows of a global batch padded as the JAX runtime pads
        it over a data split (zeros, to a power of two and a multiple of
        ``data``), and the padded row count; ``x`` itself under ``data=1``."""
        if self.mesh.data == 1:
            return x, x.shape[0]
        b_pad = pad_rows(round_up_pow2(x.shape[0]), self.mesh)
        x = torch.cat([x, x.new_zeros((b_pad - x.shape[0],) + tuple(x.shape[1:]))])
        return x[data_sharding(self.mesh, b_pad)], b_pad

    def _scope(self) -> Any:
        return model_parallel(self.mesh.model_group)

    def _agree(self, flag: bool) -> bool:
        return any_over(flag, self.mesh.world, self.device)

    def _gathered(self, *outs: torch.Tensor, rows: int) -> Tuple[np.ndarray, ...]:
        """The outputs of every data rank in row order, the first ``rows``."""
        return tuple(gather_blocks(t, self.mesh.data_group)[:rows].cpu().numpy() for t in outs)

    # -- scoring (teacher-forced logits) --------------------------------------

    def score(self, seqs: Any, seq_lens: Any, memory: Any) -> np.ndarray:
        """[B, S] ids, [B] lengths or None, [B, S_mem, D] memory -> [B, S, V]
        fp32 logits."""
        seqs_t = self._tensor(seqs, torch.int32)
        b = seqs_t.shape[0]
        seqs_t, _ = self._rows(seqs_t)
        lens_t = None if seq_lens is None else self._rows(self._tensor(seq_lens, torch.int32))[0]
        mem, _ = self._rows(self._tensor(memory, torch.float32))
        with torch.inference_mode(), matmul_precision_for(self.dtype), self._scope():
            logits = self.model(seqs_t, lens_t, mem)
            return self._gathered(logits, rows=b)[0]

    # -- beam search -----------------------------------------------------------

    def _cap_gen_len(self, config: BeamSearchConfig, prefix_len: int) -> BeamSearchConfig:
        """Cap max_gen_len so the prompt plus the generation fit the position
        table (the reference's prompt-aware cap)."""
        limit = self.max_target_len - prefix_len
        if limit < 1:
            raise ValueError(
                f"prefix of {prefix_len} tokens leaves no room to generate "
                f"(usable target length {self.max_target_len})"
            )
        if config.max_gen_len > limit:
            config = dataclasses.replace(config, max_gen_len=limit)
        return config

    def warmup(self, config: BeamSearchConfig, prefix_len: int = 2,
               batch_sizes: Sequence[int] = (32,)) -> int:
        """Run one beam decode per batch size (this builds the CUDA kernels
        on first use); returns the number of batch sizes."""
        eos = self.vocab_info.eos_idx
        d = self.model.config.model_dim
        for b in batch_sizes:
            self.generate_beam(np.zeros((b, 1, d), np.float32), [eos] * prefix_len, config)
        return len(tuple(batch_sizes))

    def generate_beam(self, memory: Any, prefix_ids: Sequence[int],
                      config: BeamSearchConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """memory: [B, 1, D] (numpy or a tensor, which may stay on the
        device); returns (tokens [B, K, T], scores [B, K], lens [B, K])."""
        config = self._cap_gen_len(config, len(prefix_ids))
        mem = self._tensor(memory, torch.float32)
        b = mem.shape[0]
        mem, _ = self._rows(mem)
        prefix = torch.tensor(list(prefix_ids), dtype=torch.long, device=self.device)
        prefix = prefix[None, :].expand(mem.shape[0], -1)
        vocab = self.vocab_info
        # normalize_scores=False is len_penalty 0, as in the JAX runtime.
        config = dataclasses.replace(
            config, normalize_scores=True,
            len_penalty=config.len_penalty if config.normalize_scores else 0.0)
        k = config.beam_size
        cache_len = len(prefix_ids) + config.max_gen_len + 1

        def step_fn(tokens, cache, ancestry):
            self.decode_steps += 1
            return self.model.step(tokens, cache, ancestry=ancestry, beam_size=k)

        with torch.inference_mode(), matmul_precision_for(self.dtype), self._scope():
            cache = self.model.init_cache(mem.repeat_interleave(k, dim=0), cache_len, beam_size=k)
            tokens, scores, lens = beam_search_lax(
                step_fn, cache, prefix, vocab.eos_idx, vocab.size, config,
                pad_idx=vocab.pad_idx or 0,
                unk_idx=vocab.unk_idx if config.unk_penalty else None,
                cache_len=cache_len, agree=self._agree,
            )
            return self._gathered(tokens, scores, lens, rows=b)

    # -- sampling ---------------------------------------------------------------

    def generate_sample(self, memory: Any, prefix_ids: Sequence[int], sampler: Any,
                        max_gen_len: int, min_gen_len: int = 1, seed: int = 0,
                        noise: Optional[Callable] = None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """memory: [B, 1, D] (numpy or a tensor); returns (tokens [B, T],
        scores [B], lens [B]) of one sampled hypothesis per row.

        The Gumbel noise comes from a ``torch.Generator`` on the decoder's
        device seeded with ``seed``, or from ``noise(step, (B, V))`` when it
        is given (``generation.sampling``). Under a data split both are drawn
        for the whole padded batch on every rank, and each rank reads its
        rows."""
        # Same prompt-aware cap as the beam path.
        max_gen_len = min(max_gen_len, self.max_target_len - len(prefix_ids))
        if max_gen_len < 1:
            raise ValueError(
                f"prefix of {len(prefix_ids)} tokens leaves no room to generate "
                f"(usable target length {self.max_target_len})"
            )
        mem = self._tensor(memory, torch.float32)
        b = mem.shape[0]
        mem, b_pad = self._rows(mem)
        prefix = torch.tensor(list(prefix_ids), dtype=torch.long, device=self.device)
        prefix = prefix[None, :].expand(mem.shape[0], -1)
        vocab = self.vocab_info
        generator = None
        if noise is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        if self.mesh.data > 1:
            rows = data_sharding(self.mesh, b_pad)
            draw = noise or (lambda step, shape: gumbel(generator, shape, self.device))

            def noise_rows(step: int, shape: Tuple[int, ...]) -> Any:
                return torch.as_tensor(draw(step, (b_pad,) + tuple(shape[1:])),
                                       dtype=torch.float32, device=self.device)[rows]

            noise = noise_rows

        def step_fn(tokens, cache):
            self.decode_steps += 1
            logits, cache = self.model.step(tokens, cache)
            return torch.log_softmax(logits.float(), dim=-1), cache

        with torch.inference_mode(), matmul_precision_for(self.dtype), self._scope():
            cache = self.model.init_cache(mem, len(prefix_ids) + max_gen_len + 1)
            tokens, scores, lens = sample_lax(
                step_fn, cache, prefix, vocab.eos_idx, vocab.size, sampler, generator,
                max_gen_len, min_gen_len, pad_idx=vocab.pad_idx or 0, noise=noise,
                agree=self._agree,
            )
            return self._gathered(tokens, scores, lens, rows=b)
