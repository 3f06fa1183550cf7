"""The general traffic generator: it reads a traffic file's parameters and
makes the cell's inputs from the seed.

Sizes are one fixed set for every seed: token lengths are the quantiles of
the file's distribution at (i + 0.5) / n, and the seed only orders them and
picks the words (or draws the embeddings), so that two seeds ask the device
for the same work.

Parameters of a text pool (``"lengths"``): ``dist`` ``lognormal`` (``mu``,
``sigma``) or ``uniform``, clipped to [``min``, ``max``] tokens, the
language code and EOS included; ``chunk`` sentences a call and
``pool_chunks`` distinct chunks, cycled if the window wants more.
"""

from __future__ import annotations

from statistics import NormalDist
from typing import List, Sequence

import numpy as np


def rng_of(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2**63), stream])


def token_lengths(spec: dict, n: int) -> np.ndarray:
    """The n lengths of ``spec``'s distribution, in ascending order."""
    q = (np.arange(n) + 0.5) / n
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(p)) for p in q])
        x = np.exp(spec["mu"] + spec["sigma"] * z)
    elif spec["dist"] == "uniform":
        x = spec["min"] + q * (spec["max"] + 1 - spec["min"]) - 0.5
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def sentences(words: Sequence[str], lens: np.ndarray, rng: np.random.Generator) -> List[str]:
    """One sentence per length: length - 2 words (the language code and EOS
    are the other two tokens)."""
    n_words = lens - 2
    picks = rng.integers(0, len(words), int(n_words.sum()))
    ends = np.cumsum(n_words)
    vocab = np.asarray(words, dtype=object)
    chosen = vocab[picks]
    return [" ".join(chosen[e - k:e]) for e, k in zip(ends, n_words)]


def text_pool(words: Sequence[str], spec: dict, chunk: int, chunks: int, seed: int
              ) -> List[List[str]]:
    """``chunks`` chunks of ``chunk`` sentences, lengths as ``spec``."""
    rng = rng_of(seed, 2)
    lens = token_lengths(spec, chunk * chunks)
    rng.shuffle(lens)
    texts = sentences(words, lens, rng)
    return [texts[i * chunk:(i + 1) * chunk] for i in range(chunks)]


def embeddings(n: int, dim: int, scale: float, seed: int) -> np.ndarray:
    """n sentence embeddings, N(0, scale^2) fp32."""
    return (rng_of(seed, 3).standard_normal((n, dim), dtype=np.float32)
            * np.float32(scale))

