"""Heart-disease tabular pipeline: loading, preprocessing, vertical splits
(numpy).

The port's own copy of the JAX package's ``data/tabular.py``, which it may
not import: the same functions giving the same bytes for one seed. Reads
heart.csv from an explicit path, $DDL_HEART_CSV or ./data/heart.csv (the
repository's own data directory; nothing outside the checkout is read);
otherwise synthesizes a statistically similar dataset from a noisy linear
model over a few risk features (1,025 rows, 13 columns). ``preprocess``
one-hot expands the categorical columns and MinMax-scales the rest; the
partitioners deal whole base features to parties (even round-robin, or
at least ``min_features`` each with duplication).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

COLUMNS = ["age", "sex", "cp", "trestbps", "chol", "fbs", "restecg",
           "thalach", "exang", "oldpeak", "slope", "ca", "thal"]
CATEGORICAL = ["cp", "restecg", "slope", "ca", "thal"]
TARGET = "target"

_SEARCH = ("data/heart.csv",)


def synthetic_heart(n: int = 1025, seed: int = 7) -> Tuple[np.ndarray, np.ndarray]:
    """Rows mimicking heart.csv's columns/ranges, labels from a noisy linear
    model over a few risk features — learnable to roughly the reference's
    ~85% accuracy regime."""
    rng = np.random.default_rng(seed)
    age = rng.integers(29, 78, n)
    sex = rng.integers(0, 2, n)
    cp = rng.integers(0, 4, n)
    trestbps = rng.integers(94, 201, n)
    chol = rng.integers(126, 565, n)
    fbs = rng.integers(0, 2, n)
    restecg = rng.integers(0, 3, n)
    thalach = rng.integers(71, 203, n)
    exang = rng.integers(0, 2, n)
    oldpeak = np.round(rng.uniform(0, 6.2, n), 1)
    slope = rng.integers(0, 3, n)
    ca = rng.integers(0, 5, n)
    thal = rng.integers(0, 4, n)
    logit = (
        -0.04 * (age - 54) + 0.9 * (cp > 0) - 0.02 * (trestbps - 130)
        + 0.025 * (thalach - 150) - 1.1 * exang - 0.7 * oldpeak
        + 0.5 * (slope == 2) - 0.8 * (ca > 0) - 0.9 * (thal == 3) + 0.6
        + rng.normal(0, 0.8, n)
    )
    target = (logit > 0).astype(np.int64)
    X = np.stack([age, sex, cp, trestbps, chol, fbs, restecg, thalach,
                  exang, oldpeak, slope, ca, thal], axis=1).astype(np.float64)
    return X, target


def load_heart(path: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (X [N, 13] float64 raw columns, y [N] int64)."""
    candidates = [path, os.environ.get("DDL_HEART_CSV"), *_SEARCH]
    for c in candidates:
        if c and os.path.exists(c):
            raw = np.genfromtxt(c, delimiter=",", names=True)
            X = np.stack([raw[name] for name in COLUMNS], axis=1)
            y = raw[TARGET].astype(np.int64)
            return X, y
    return synthetic_heart()


def preprocess(X: np.ndarray, *, onehot: bool = True
               ) -> Tuple[np.ndarray, List[str]]:
    """One-hot expand categoricals, MinMax-scale everything to [0, 1].

    Returns (features [N, D], feature_names) where one-hot columns are named
    ``<col>_<value>`` — the naming the feature partitioners group by.
    """
    cols: List[np.ndarray] = []
    names: List[str] = []
    for j, name in enumerate(COLUMNS):
        v = X[:, j]
        if onehot and name in CATEGORICAL:
            values = np.unique(v)
            for val in values:
                cols.append((v == val).astype(np.float32))
                names.append(f"{name}_{int(val)}")
        else:
            lo, hi = v.min(), v.max()
            cols.append(((v - lo) / (hi - lo if hi > lo else 1.0)).astype(np.float32))
            names.append(name)
    return np.stack(cols, axis=1), names


def train_test_split(X: np.ndarray, y: np.ndarray, *, test_fraction: float = 0.2,
                     seed: int = 0, dedup: bool = False):
    """Seeded random split. With ``dedup``, duplicate rows are grouped so no
    test row has an identical twin in train.

    The Kaggle heart.csv the reference uses (1025 rows) is the 303-row UCI
    set expanded with duplicates; a plain random split leaks most test rows
    into train, so a well-trained model scores ≈100% (the reference's
    ≈85% band survives only because of its optimizer quirks). ``dedup=True``
    is the honest-generalization protocol; the default matches the
    reference's leaky protocol for comparability.
    """
    rng = np.random.default_rng(seed)
    if dedup:
        rows = np.concatenate([X, y[:, None].astype(X.dtype)], axis=1)
        _, group = np.unique(rows, axis=0, return_inverse=True)
        n_groups = group.max() + 1
        gperm = rng.permutation(n_groups)
        n_test_groups = int(n_groups * test_fraction)
        test_groups = set(gperm[:n_test_groups].tolist())
        is_test = np.asarray([g in test_groups for g in group])
        te, tr = np.where(is_test)[0], np.where(~is_test)[0]
    else:
        perm = rng.permutation(len(y))
        n_test = int(len(y) * test_fraction)
        te, tr = perm[:n_test], perm[n_test:]
    return X[tr], y[tr], X[te], y[te]


# ------------------------------------------------- vertical feature partitioners

def base_feature_groups(names: Sequence[str]) -> List[List[int]]:
    """Group one-hot columns of the same base feature together so a vertical
    partition never splits a single original column across parties."""
    groups: Dict[str, List[int]] = {}
    for i, n in enumerate(names):
        base = n.rsplit("_", 1)[0] if "_" in n and n.rsplit("_", 1)[0] in CATEGORICAL else n
        groups.setdefault(base, []).append(i)
    return [groups[k] for k in sorted(groups, key=lambda k: groups[k][0])]


def split_features_evenly(names: Sequence[str], nr_clients: int, *, seed: Optional[int] = None
                          ) -> List[List[int]]:
    """Deal base features round-robin (optionally after a seeded permutation)
    — hw2's even partitioner (Tea_Pula_HW2.ipynb cell 13)."""
    groups = base_feature_groups(names)
    if seed is not None:
        rng = np.random.default_rng(seed)
        groups = [groups[i] for i in rng.permutation(len(groups))]
    parts: List[List[int]] = [[] for _ in range(nr_clients)]
    for i, g in enumerate(groups):
        parts[i % nr_clients].extend(g)
    return parts


def split_features_with_minimum(names: Sequence[str], nr_clients: int, *,
                                min_features: int = 2, seed: int = 0) -> List[List[int]]:
    """Every client gets at least ``min_features`` base features, duplicating
    features when there aren't enough to go around — hw2's min-2 policy
    (Tea_Pula_HW2.ipynb cell 20)."""
    groups = base_feature_groups(names)
    min_features = min(min_features, len(groups))  # can't hold more than exist
    rng = np.random.default_rng(seed)
    parts: List[List[int]] = [[] for _ in range(nr_clients)]
    order = list(rng.permutation(len(groups)))
    for i, g in enumerate(order):
        parts[i % nr_clients].extend(groups[g])
    for p in parts:
        held = {tuple(g) for g in groups if set(g) <= set(p)}
        while len(held) < min_features:
            extra = groups[rng.integers(len(groups))]
            if tuple(extra) not in held:
                p.extend(extra)
                held.add(tuple(extra))
    return parts
