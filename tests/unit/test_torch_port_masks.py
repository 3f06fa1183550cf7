"""The port's last public names that ``sonar_tpu`` has, against its own.

``ConfigRegistry.names()`` of every registry (the same names, sorted) and
``ops.masks.mask_from_lengths``, ``apply_padding_mask`` and
``combine_masks`` on the same inputs (equal bit for bit; None passed
through as JAX passes it).
"""

import importlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sonar_tpu.ops import masks as jmasks  # noqa: E402
from sonar_tpu_torch.ops import masks  # noqa: E402

REGISTRIES = [
    ("models.sonar_text.config", "sonar_text_encoder_archs"),
    ("models.sonar_text.config", "sonar_text_decoder_archs"),
    ("models.sonar_speech.config", "sonar_speech_encoder_archs"),
    ("models.laser2_text.model", "laser2_archs"),
    ("models.mutox.model", "mutox_archs"),
    ("models.blaser.model", "blaser_archs"),
]


@pytest.mark.parametrize("module,name", REGISTRIES, ids=[r[1] for r in REGISTRIES])
def test_registry_names_match_jax(module, name):
    want = getattr(importlib.import_module(f"sonar_tpu.{module}"), name).names()
    got = getattr(importlib.import_module(f"sonar_tpu_torch.{module}"), name).names()
    assert got == want and got == sorted(got) and got


def test_mask_from_lengths_matches_jax():
    lens = np.asarray([0, 3, 7, 5], np.int32)
    want = np.asarray(jmasks.mask_from_lengths(jnp.asarray(lens), 7))
    got = masks.mask_from_lengths(torch.tensor(lens), 7)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert masks.mask_from_lengths(None, 7) is None and jmasks.mask_from_lengths(None, 7) is None


@pytest.mark.parametrize("pad_value", [0.0, -2.5])
def test_apply_padding_mask_matches_jax(pad_value):
    rng = np.random.default_rng(0)
    seqs = rng.normal(size=(3, 5, 4)).astype(np.float32)
    mask = rng.random((3, 5)) < 0.6
    want = np.asarray(jmasks.apply_padding_mask(jnp.asarray(seqs), jnp.asarray(mask), pad_value))
    got = masks.apply_padding_mask(torch.tensor(seqs), torch.tensor(mask), pad_value)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(masks.apply_padding_mask(torch.tensor(seqs), None).numpy(), seqs)


def test_combine_masks_matches_jax():
    rng = np.random.default_rng(1)
    a, b = rng.random((2, 1, 6)) < 0.5, rng.random((1, 4, 6)) < 0.5
    want = np.asarray(jmasks.combine_masks(jnp.asarray(a), None, jnp.asarray(b)))
    got = masks.combine_masks(torch.tensor(a), None, torch.tensor(b))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (2, 4, 6)
    np.testing.assert_array_equal(masks.combine_masks(None, torch.tensor(a)).numpy(), a)
    assert masks.combine_masks() is None and masks.combine_masks(None, None) is None
