"""MNIST pipeline: loading, normalization, and federated splits (numpy).

The port's own copy of the JAX package's ``data/mnist.py``, which it may
not import: the same functions giving the same bytes for one seed. Reads
standard IDX files (optionally .gz) from an explicit directory,
$DDL_MNIST_DIR or ./data/mnist; otherwise generates the deterministic
procedural digit dataset (bitmap-font glyphs + jitter + noise) with
MNIST's shapes, so every run works with no network. Normalization uses
MNIST's constants (0.1307, 0.3081). ``split`` deals IID (a seeded
permutation in N equal parts) or non-IID (sorted by label into 2N shards,
2 random shards per client).
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import List, Optional, Tuple

import numpy as np

MEAN, STD = 0.1307, 0.3081  # the reference's normalization constants

# 7x5 bitmap font for the ten digits — the synthetic fallback's glyph source.
_FONT = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11110", "00001", "00001", "01110", "00001", "00001", "11110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    magic, = struct.unpack(">i", data[:4])
    ndim = magic & 0xFF
    dims = struct.unpack(">" + "i" * ndim, data[4:4 + 4 * ndim])
    return np.frombuffer(data, dtype=np.uint8, offset=4 + 4 * ndim).reshape(dims)


def _find_idx(data_dir: str, stem: str) -> Optional[str]:
    for suffix in ("", ".gz"):
        p = os.path.join(data_dir, stem + suffix)
        if os.path.exists(p):
            return p
    return None


def _glyph(digit: int) -> np.ndarray:
    g = np.array([[int(c) for c in row] for row in _FONT[digit]], dtype=np.float32)
    # upscale 7x5 -> 21x15, centered on a 28x28 canvas
    up = np.kron(g, np.ones((3, 3), dtype=np.float32))
    canvas = np.zeros((28, 28), dtype=np.float32)
    canvas[3:24, 6:21] = up
    return canvas


def synthetic_mnist(n_train: int = 60000, n_test: int = 10000, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic digit dataset with MNIST shapes: images uint8 [N,28,28],
    labels uint8 [N]. Glyphs are jittered (±3 px), scaled in intensity, and
    noised — linearly separable enough to train, hard enough to need learning."""
    rng = np.random.default_rng(seed)
    glyphs = np.stack([_glyph(d) for d in range(10)])

    def make(n, rng):
        labels = rng.integers(0, 10, size=n).astype(np.uint8)
        images = np.zeros((n, 28, 28), dtype=np.float32)
        dx = rng.integers(-3, 4, size=n)
        dy = rng.integers(-3, 4, size=n)
        intensity = rng.uniform(0.6, 1.0, size=n).astype(np.float32)
        noise = rng.normal(0.0, 0.08, size=(n, 28, 28)).astype(np.float32)
        for i in range(n):
            images[i] = np.roll(np.roll(glyphs[labels[i]], dy[i], axis=0), dx[i], axis=1)
        images = np.clip(images * intensity[:, None, None] + noise, 0.0, 1.0)
        return (images * 255).astype(np.uint8), labels

    x_train, y_train = make(n_train, rng)
    x_test, y_test = make(n_test, rng)
    return x_train, y_train, x_test, y_test


def load_mnist(data_dir: Optional[str] = None, *, n_train: int = 60000,
               n_test: int = 10000, seed: int = 0):
    """(x_train, y_train, x_test, y_test) as raw uint8 arrays.

    Search order: explicit dir, $DDL_MNIST_DIR, ./data/mnist (IDX files,
    gzipped or not); falls back to the synthetic procedural dataset.
    """
    for d in (data_dir, os.environ.get("DDL_MNIST_DIR"), "data/mnist"):
        if not d or not os.path.isdir(d):
            continue
        paths = [_find_idx(d, s) for s in (
            "train-images-idx3-ubyte", "train-labels-idx1-ubyte",
            "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")]
        if all(paths):
            return (_read_idx(paths[0]), _read_idx(paths[1]),
                    _read_idx(paths[2]), _read_idx(paths[3]))
    return synthetic_mnist(n_train, n_test, seed)


def normalize(images: np.ndarray) -> np.ndarray:
    """uint8 [N,28,28] -> normalized float32 NCHW [N,1,28,28] with the
    reference's constants (hfl_complete.py:23)."""
    x = images.astype(np.float32) / 255.0
    return ((x - MEAN) / STD)[:, None, :, :]


def split(labels: np.ndarray, nr_clients: int, iid: bool, seed: int) -> List[np.ndarray]:
    """Partition example indices across clients.

    IID: seeded permutation dealt evenly. Non-IID: sort by label, cut into
    2·N contiguous shards, deal 2 random shards to each client — the
    reference's pathological label-skew scheme (hfl_complete.py:91-104).
    """
    rng = np.random.default_rng(seed)
    n = len(labels)
    if iid:
        perm = rng.permutation(n)
        return [np.sort(s) for s in np.array_split(perm, nr_clients)]
    order = np.argsort(labels, kind="stable")
    shards = np.array_split(order, 2 * nr_clients)
    shard_perm = rng.permutation(2 * nr_clients)
    return [
        np.sort(np.concatenate([shards[shard_perm[2 * i]], shards[shard_perm[2 * i + 1]]]))
        for i in range(nr_clients)
    ]
