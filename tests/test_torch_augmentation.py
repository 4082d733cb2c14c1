"""The port's search augmentation against the JAX package's.

The two packages cannot draw the same random bits, so the transforms are
held against each other through their cores: the test draws the offsets,
flips and cutout centres with ``jax.random`` exactly as the JAX transform
does, feeds them to the port's core, and compares with the JAX transform's
images.  The port's own draw is checked for range, reproducibility from
``(key, step)``, and variation across steps and samples.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katib_tpu.models import augmentation as jaug
from katib_tpu_torch.models import augmentation as taug

torch.set_num_threads(1)


def _images(b=6, h=8, w=10, c=3, seed=0):
    return np.random.default_rng(seed).normal(size=(b, h, w, c)).astype(np.float32)


def _jax_crop_flip_draws(key, b, padding):
    """``katib_tpu.models.augmentation.random_crop_flip``'s own draws."""
    k_y, k_x, k_f = jax.random.split(key, 3)
    off_y = jax.random.randint(k_y, (b,), 0, 2 * padding + 1)
    off_x = jax.random.randint(k_x, (b,), 0, 2 * padding + 1)
    flip = jax.random.bernoulli(k_f, 0.5, (b,))
    return [torch.from_numpy(np.asarray(t).astype(np.int64)) for t in (off_y, off_x, flip)]


def _jax_cutout_draws(key, b, h, w):
    k_y, k_x = jax.random.split(key)
    return [torch.from_numpy(np.asarray(t).astype(np.int64))
            for t in (jax.random.randint(k_y, (b,), 0, h), jax.random.randint(k_x, (b,), 0, w))]


@pytest.mark.parametrize("seed,padding", [(0, 4), (1, 4), (2, 2)])
def test_crop_flip_core_gives_the_jax_images(seed, padding):
    x = _images(seed=seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaug.random_crop_flip(key, jnp.asarray(x), padding=padding))
    got = taug.crop_flip(torch.from_numpy(x), *_jax_crop_flip_draws(key, len(x), padding),
                         padding=padding)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,length", [(0, 16), (3, 4), (4, 5)])
def test_cutout_core_gives_the_jax_images(seed, length):
    x = _images(seed=seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaug.cutout(key, jnp.asarray(x), length=length))
    got = taug.cutout_at(torch.from_numpy(x), *_jax_cutout_draws(key, *x.shape[:3]),
                         length=length)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cifar_pipeline_cores_give_the_jax_images():
    x = _images(h=32, w=32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jaug.cifar_train_augment(key, jnp.asarray(x)))
    k_crop, k_cut = jax.random.split(key)
    got = taug.crop_flip(torch.from_numpy(x), *_jax_crop_flip_draws(k_crop, len(x), 4))
    got = taug.cutout_at(got, *_jax_cutout_draws(k_cut, len(x), 32, 32), length=16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_draws_are_in_range_reproducible_and_vary():
    step = torch.tensor(5, dtype=torch.int32)
    n = 4096
    for span in (9, 2, 32):
        d = taug.draw_int(11, step, n, 0, span)
        assert d.dtype == torch.int64 and d.shape == (n,)
        assert int(d.min()) == 0 and int(d.max()) == span - 1
        # roughly uniform: every value drawn near n/span times
        counts = torch.bincount(d, minlength=span).float()
        assert float((counts - n / span).abs().max()) < 6 * (n / span) ** 0.5
    a = taug.draw_int(11, step, 64, 0, 9)
    assert torch.equal(a, taug.draw_int(11, torch.tensor(5, dtype=torch.int32), 64, 0, 9))
    assert not torch.equal(a, taug.draw_int(11, torch.tensor(6, dtype=torch.int32), 64, 0, 9))
    assert not torch.equal(a, taug.draw_int(12, step, 64, 0, 9))
    assert not torch.equal(a, taug.draw_int(11, step, 64, 1, 9))
    assert len(set(a.tolist())) > 5  # samples differ within a step


def test_transforms_from_the_draws():
    x = torch.from_numpy(_images(b=32, h=32, w=32))
    step = torch.tensor(3, dtype=torch.int32)
    out = taug.random_crop_flip(7, step, x)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert torch.equal(out, taug.random_crop_flip(7, step, x))
    assert not torch.equal(out, taug.random_crop_flip(7, step + 1, x))
    # each sample is a shifted (maybe mirrored) window of its own padded image
    oy, ox, fl = (taug.draw_int(7, step, 32, s, n) for s, n in ((0, 9), (1, 9), (2, 2)))
    assert torch.equal(out, taug.crop_flip(x, oy, ox, fl))
    cut = taug.cutout(7, step, x, length=8)
    zeroed = (cut == 0).all(dim=-1).sum(dim=(1, 2))
    assert bool((zeroed >= 16).all()) and bool((zeroed <= 64).all())
    aug = taug.make_cifar_augment()
    assert aug == taug.make_cifar_augment() and hash(aug) == hash(taug.CifarAugment())
    assert torch.equal(aug(7, step, x), taug.cifar_train_augment(7, step, x))


def test_bf16_images_keep_their_dtype():
    x = torch.from_numpy(_images()).to(torch.bfloat16)
    step = torch.tensor(0, dtype=torch.int32)
    out = taug.cifar_train_augment(1, step, x, cutout_length=4)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
