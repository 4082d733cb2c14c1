"""Device-side image augmentation (port of ``katib_tpu/models/augmentation.py``).

The reference trial image trains CIFAR-10 with RandomCrop(32, padding=4),
RandomHorizontalFlip and Cutout(16) on its host data loader.  Here they are
batch transforms on NHWC tensors that run on the batch's device, inside the
bilevel step (and inside its CUDA-graph capture): static shapes, no value
read back to the host.

Each transform is split in two:

- a **core** that takes explicit per-sample values (crop offsets and flips,
  cutout centres) and applies them: :func:`crop_flip`, :func:`cutout_at`.
  Given the same values the cores give the JAX transforms' images;
- a **draw** of those values that is counter-based on the device: a hash of
  ``(key, step, sample, stream)``, where ``key`` is an integer (the search
  and the trainer pass ``seed + KEY_OFFSET``, the JAX package's
  ``seed + 0x5EED``) and ``step`` the state's 0-d step counter.  A draw is
  reproducible from the seed, the same after a resume (the counter is part
  of the checkpoint) and capturable.  It cannot reproduce ``jax.random``'s
  bits: the two packages draw different offsets from the same seed, so
  augmented runs agree with the JAX package in distribution, not sample by
  sample.

An augment function takes ``(key, step, x)`` and returns the augmented
``x``: :func:`random_crop_flip`, :func:`cutout`, :func:`cifar_train_augment`
and the value-hashable :class:`CifarAugment` from :func:`make_cifar_augment`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

KEY_OFFSET = 0x5EED  # a run's augmentation key is its seed + this, as in the JAX package
_MASK32 = 0xFFFFFFFF
# stream ids: one independent draw per per-sample value
_CROP_Y, _CROP_X, _FLIP, _CUT_Y, _CUT_X = range(5)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for ``x`` in [0, 2**32) held in int64, without
    overflowing int64 (the constant is split into 16-bit halves)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser (murmur3's ``fmix32``) on int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _draw_uint32(key: int, step: torch.Tensor, n: int, stream: int) -> torch.Tensor:
    """``n`` 32-bit draws (int64 values in [0, 2**32)), one per sample, a
    function of ``(key, step, sample, stream)`` only; on ``step``'s device."""
    base = _hash32(torch.full((), key & _MASK32, dtype=torch.int64, device=step.device))
    base = _hash32(base ^ (step.to(torch.int64) & _MASK32))
    sample = torch.arange(n, dtype=torch.int64, device=step.device)
    return _hash32(_hash32(base ^ (sample * 8 + stream)) ^ stream)


def draw_int(key: int, step: torch.Tensor, n: int, stream: int, high: int) -> torch.Tensor:
    """``n`` integers in ``[0, high)`` (a modulo of 32-bit draws; the bias is
    under ``high / 2**32``)."""
    return _draw_uint32(key, step, n, stream) % high


def crop_flip(x: torch.Tensor, off_y: torch.Tensor, off_x: torch.Tensor, flip: torch.Tensor,
              padding: int = 4) -> torch.Tensor:
    """Zero-pad NHWC ``x`` by ``padding``, crop each sample back to HxW at
    ``(off_y, off_x)`` (each in ``[0, 2 * padding]``) and mirror it
    left-right where ``flip`` is true: RandomCrop(padding) +
    RandomHorizontalFlip with the draws given."""
    b, h, w, _ = x.shape
    padded = F.pad(x, (0, 0, padding, padding, padding, padding))
    ys = off_y[:, None] + torch.arange(h, device=x.device)
    cols = torch.arange(w, device=x.device)
    cols = torch.where(flip[:, None].bool(), w - 1 - cols, cols)
    xs = off_x[:, None] + cols
    rows = torch.arange(b, device=x.device)[:, None, None]
    return padded[rows, ys[:, :, None], xs[:, None, :]]


def cutout_at(x: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor, length: int = 16) -> torch.Tensor:
    """Zero a ``length`` x ``length`` square of each NHWC sample centred at
    ``(cy, cx)``, half-open ``[c - length//2, c + length//2)`` and clipped at
    the borders: the reference's Cutout."""
    _, h, w, _ = x.shape
    half = length // 2
    dy = torch.arange(h, device=x.device)[None, :, None] - cy[:, None, None]
    dx = torch.arange(w, device=x.device)[None, None, :] - cx[:, None, None]
    inside = (dy >= -half) & (dy < half) & (dx >= -half) & (dx < half)
    return torch.where(inside[..., None], torch.zeros((), dtype=x.dtype, device=x.device), x)


def random_crop_flip(key: int, step: torch.Tensor, x: torch.Tensor, padding: int = 4):
    """:func:`crop_flip` at drawn offsets and flips."""
    b = x.shape[0]
    span = 2 * padding + 1
    return crop_flip(
        x,
        draw_int(key, step, b, _CROP_Y, span),
        draw_int(key, step, b, _CROP_X, span),
        draw_int(key, step, b, _FLIP, 2),
        padding,
    )


def cutout(key: int, step: torch.Tensor, x: torch.Tensor, length: int = 16):
    """:func:`cutout_at` at drawn centres (each in ``[0, H)`` x ``[0, W)``)."""
    b, h, w, _ = x.shape
    return cutout_at(x, draw_int(key, step, b, _CUT_Y, h), draw_int(key, step, b, _CUT_X, w),
                     length)


def cifar_train_augment(key: int, step: torch.Tensor, x: torch.Tensor, *, padding: int = 4,
                        cutout_length: int = 16):
    """The reference's CIFAR-10 train-time pipeline: crop + flip, then cutout
    (the streams differ, so the two draws are independent)."""
    return cutout(key, step, random_crop_flip(key, step, x, padding), cutout_length)


@dataclasses.dataclass(frozen=True)
class CifarAugment:
    """Value-hashable :func:`cifar_train_augment` with fixed parameters."""

    padding: int = 4
    cutout_length: int = 16

    def __call__(self, key: int, step: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return cifar_train_augment(key, step, x, padding=self.padding,
                                   cutout_length=self.cutout_length)


def make_cifar_augment(padding: int = 4, cutout_length: int = 16) -> CifarAugment:
    return CifarAugment(padding=padding, cutout_length=cutout_length)
