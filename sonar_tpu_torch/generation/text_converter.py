"""Embedding -> text and text -> text through the embedding
(``sonar_tpu.generation.text_converter``).

The NLLB decoder prompt is ``[</s>, <target_lang>]`` (the tokenizer's
target-mode prefix); the best hypothesis of each row is cut at its length
and SentencePiece-decoded with control tokens filtered. An encoder-decoder
model's encoder (``TorchEncoderDecoder``) hands the decoder a sequence
memory and its lengths (``SequenceMemory``) in place of the embedding; the
decode goes through the same entry points.

As in the JAX package, a batch's decode can be dispatched and resolved
later (``dispatch_convert`` / ``finish_convert``, ``dispatch_translate``),
and ``translate_stream`` keeps a window of batches in flight
(``runtime.stream_in_window``).
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, List, Sequence

import numpy as np
from sonar_tpu_torch.data.collate import Collater, DEFAULT_LEN_BUCKETS
from sonar_tpu_torch.generation.beam_search import BeamSearchConfig
from sonar_tpu_torch.runtime import stream_in_window
from sonar_tpu_torch.utils.profiling import span
import torch


def _decode_hypotheses(tokenizer: Any, tokens: np.ndarray, lens: np.ndarray) -> List[str]:
    """tokens: [B, T] best hypotheses (generated part incl. EOS)."""
    with span("pipeline.detokenize", rows=len(tokens)):
        decoder = tokenizer.create_decoder()
        return [decoder([int(t) for t in row[: int(n)]]) for row, n in zip(tokens, lens)]


class EmbeddingToTextConverter:
    """Embeddings -> texts with beam search, or with ``sampler`` (a
    ``TopPSampler`` / ``TopKSampler``) one sampled hypothesis per row, its
    noise drawn from ``seed`` for every batch."""

    def __init__(self, decoder: Any, tokenizer: Any, target_lang: str,
                 gen_config: BeamSearchConfig, sampler: Any = None, seed: int = 0):
        self.decoder = decoder
        self.tokenizer = tokenizer
        self.gen_config = gen_config
        self.sampler = sampler
        self.seed = seed
        target_encoder = tokenizer.create_encoder(lang=target_lang, mode="target")
        self.prefix_ids: List[int] = list(target_encoder.prefix_indices)

    def batch_convert(self, embeddings: Any) -> List[str]:
        """[B, D] sentence embeddings (numpy, or a tensor that may stay on
        the device) -> B decoded strings."""
        return self.finish_convert(self.dispatch_convert(embeddings))

    def dispatch_convert(self, embeddings: Any) -> Any:
        """Start decoding a batch without blocking; resolve the returned
        handle with ``finish_convert``. Beam decode dispatches
        (``generate_beam_async``); sampling runs its loop here and returns
        the strings, as the JAX package's does."""
        if hasattr(embeddings, "lens"):  # a sequence memory and its lengths
            if self.sampler is not None:
                raise NotImplementedError("sampling decodes a length-1 memory only")
            return self.decoder.generate_beam_async(embeddings, self.prefix_ids,
                                                    self.gen_config)
        if torch.is_tensor(embeddings):
            memory = embeddings.float()[:, None, :]
        else:
            memory = np.asarray(embeddings, np.float32)[:, None, :]
        if self.sampler is not None:
            tokens, _, lens = self.decoder.generate_sample(
                memory, self.prefix_ids, self.sampler, max_gen_len=self.gen_config.max_gen_len,
                min_gen_len=self.gen_config.min_gen_len, seed=self.seed)
            return _decode_hypotheses(self.tokenizer, tokens, lens)
        return self.decoder.generate_beam_async(memory, self.prefix_ids, self.gen_config)

    def finish_convert(self, handle: Any) -> List[str]:
        """Materialize a ``dispatch_convert`` handle -> decoded strings."""
        if isinstance(handle, list):  # sampling's strings
            return handle
        tokens, _, lens = self.decoder.materialize_beam(handle)
        return _decode_hypotheses(self.tokenizer, tokens[:, 0], lens[:, 0])


class TextTranslator:
    """Source texts -> embeddings (encoder) -> target texts (decoder); or,
    for an encoder-decoder model, source texts -> the source's memory ->
    target texts."""

    def __init__(self, encoder: Any, decoder: Any, tokenizer: Any, source_lang: str,
                 target_lang: str, gen_config: BeamSearchConfig):
        self.encoder = encoder
        self.converter = EmbeddingToTextConverter(decoder, tokenizer, target_lang, gen_config)
        self.source_encoder = tokenizer.create_encoder(lang=source_lang, mode="source")
        self.collater = Collater(tokenizer.vocab_info.pad_idx, len_buckets=DEFAULT_LEN_BUCKETS)

    def batch_translate(self, texts: Sequence[str]) -> List[str]:
        return self.converter.finish_convert(self.dispatch_translate(texts))

    def dispatch_translate(self, texts: Sequence[str]) -> Any:
        """Tokenize, collate and dispatch the encode and the decode ->
        an in-flight handle (resolve with ``converter.finish_convert``)."""
        encode_batch = getattr(self.source_encoder, "encode_batch", None)
        if encode_batch is not None:  # one native call for the batch
            token_lists = encode_batch(texts)
        else:
            token_lists = [self.source_encoder(t) for t in texts]
        max_len = self.encoder.max_source_len
        batch = self.collater([ids[:max_len] for ids in token_lists])
        # The embeddings stay on the device into the decoder.
        embeddings = self.encoder.encode_batch(batch, materialize=False)
        return self.converter.dispatch_convert(embeddings)

    def translate_stream(self, chunks: Iterable[Sequence[str]],
                         window: int = 2) -> Iterator[List[str]]:
        """Translations of each chunk of texts, in order, with up to
        ``window`` batches in flight: batch i + 1's tokenizing, encode and
        decode dispatch run while batch i decodes, and batch i's
        materialize and detokenizing while batch i + 1 computes. The same
        results as ``batch_translate`` chunk by chunk."""
        return stream_in_window((self.dispatch_translate(t) for t in chunks),
                                self.converter.finish_convert, window)
