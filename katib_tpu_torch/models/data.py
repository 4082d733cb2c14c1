"""Datasets for trial workloads: the numpy-only loaders the DARTS trial needs.

Copy of the matching parts of ``katib_tpu/models/data.py``, with the same
seeds, so both packages make the same synthetic datasets.  Each loader first
looks for a cached copy on disk (numpy ``.npz`` with
``x_train/y_train/x_test/y_test`` in ``KATIB_DATA_DIR`` or ``./data``) and
otherwise falls back to a *structured synthetic* dataset: class prototypes
+ noise + class-correlated spatial patterns, learnable, so the search has a
real signal to optimize.
"""

from __future__ import annotations

import os
import zlib
from typing import NamedTuple

import numpy as np

DATA_DIR_ENV = "KATIB_DATA_DIR"


class Dataset(NamedTuple):
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int

    @property
    def input_shape(self) -> tuple[int, ...]:
        return tuple(self.x_train.shape[1:])


def _find_npz(name: str) -> str | None:
    for root in (os.environ.get(DATA_DIR_ENV, ""), "data"):
        if not root:
            continue
        path = os.path.join(root, f"{name}.npz")
        if os.path.exists(path):
            return path
    return None


def synthetic_classification(
    n_train: int,
    n_test: int,
    shape: tuple[int, ...],
    num_classes: int,
    seed: int = 0,
    noise: float = 1.0,
) -> Dataset:
    """Learnable synthetic image classification.

    Each class gets a smooth random prototype plus a localized high-frequency
    signature; samples are prototype + Gaussian noise."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(0.0, 1.0, size=(num_classes, *shape)).astype(np.float32)
    # smooth prototypes (class identity is low-frequency)
    for _ in range(2):
        if len(shape) >= 2:
            protos = (
                protos
                + np.roll(protos, 1, axis=1)
                + np.roll(protos, -1, axis=1)
                + np.roll(protos, 1, axis=2)
                + np.roll(protos, -1, axis=2)
            ) / 5.0

    def make(n: int, split_seed: int):
        r = np.random.default_rng(seed + split_seed)
        y = r.integers(num_classes, size=n)
        x = protos[y] + r.normal(0.0, noise, size=(n, *shape)).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int32)

    x_train, y_train = make(n_train, 1)
    x_test, y_test = make(n_test, 2)
    return Dataset(x_train, y_train, x_test, y_test, num_classes)


def _load_or_synthesize(
    name: str, shape: tuple[int, ...], num_classes: int, n_train: int, n_test: int
) -> Dataset:
    path = _find_npz(name)
    if path:
        z = np.load(path)
        x_train = z["x_train"].astype(np.float32)
        x_test = z["x_test"].astype(np.float32)
        if x_train.max() > 2.0:  # raw uint8 pixels
            x_train, x_test = x_train / 255.0, x_test / 255.0
        if x_train.ndim == 3:  # add channel dim
            x_train, x_test = x_train[..., None], x_test[..., None]
        return Dataset(
            x_train,
            z["y_train"].astype(np.int32).reshape(-1),
            x_test,
            z["y_test"].astype(np.int32).reshape(-1),
            num_classes,
        )
    # crc32, not hash(): hash() is salted per-process, and trials in
    # separate processes must all see the SAME dataset
    seed = zlib.crc32(name.encode()) % 2**31
    return synthetic_classification(n_train, n_test, shape, num_classes, seed=seed)


def load_digits_real(n_train: int = 1400, n_test: int = 397) -> Dataset:
    """Real handwritten digits bundled with scikit-learn (1797 samples of
    8x8 grayscale).  Needs scikit-learn; raises ImportError without it."""
    from sklearn.datasets import load_digits as _sk_load

    d = _sk_load()
    n_total = len(d.images)
    n_train = min(n_train, n_total - 1)
    n_test = min(n_test, n_total - n_train)
    rng = np.random.default_rng(0)
    perm = rng.permutation(n_total)
    x = (d.images[perm].astype(np.float32) / 16.0)[..., None]  # [N, 8, 8, 1]
    y = d.target[perm].astype(np.int32)
    return Dataset(
        x_train=x[:n_train],
        y_train=y[:n_train],
        x_test=x[n_train : n_train + n_test],
        y_test=y[n_train : n_train + n_test],
        num_classes=10,
    )


def load_mnist(n_train: int = 8192, n_test: int = 2048) -> Dataset:
    return _load_or_synthesize("mnist", (28, 28, 1), 10, n_train, n_test)


def load_cifar10(n_train: int = 8192, n_test: int = 2048) -> Dataset:
    return _load_or_synthesize("cifar10", (32, 32, 3), 10, n_train, n_test)


NAMED_DATASETS = ("cifar10", "digits", "mnist")


def load_named_dataset(
    name: str, n_train: int | None = None, n_test: int | None = None
) -> Dataset:
    """``"digits"`` = the bundled real dataset; ``"cifar10"``/``"mnist"`` =
    npz-backed loaders (real via ``KATIB_DATA_DIR``, structured synthetic
    fallback otherwise).  Split defaults are each loader's own."""
    kwargs = {}
    if n_train is not None:
        kwargs["n_train"] = n_train
    if n_test is not None:
        kwargs["n_test"] = n_test
    if name == "digits":
        return load_digits_real(**kwargs)
    if name == "cifar10":
        return load_cifar10(**kwargs)
    if name == "mnist":
        return load_mnist(**kwargs)
    raise ValueError(
        f"unknown dataset {name!r} (expected one of {NAMED_DATASETS})"
    )
