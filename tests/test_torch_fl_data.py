"""The port's FL host side against the JAX package's: the MNIST data
(synthetic generator, IDX reader, normalization, IID and non-IID splits),
the client-axis layout, ``FLConfig``, the seed formula, the Byzantine
injection mask and the metrics are exactly equal; client sampling keeps
its contract (without replacement, reproducible per round)."""

import dataclasses
import gzip
import struct

import numpy as np
import pytest
import torch

from ddl25spring_tpu import config as jconfig
from ddl25spring_tpu import metrics as jmetrics
from ddl25spring_tpu import rng as jrng
from ddl25spring_tpu.data import mnist as jmnist
from ddl25spring_tpu.fl import attacks as jattacks
from ddl25spring_tpu.fl import federate as jfederate
from ddl25spring_tpu_torch import config, metrics, rng
from ddl25spring_tpu_torch.data import mnist
from ddl25spring_tpu_torch.fl import attacks, federate

torch.set_num_threads(1)


def test_fl_config_defaults_and_clients_per_round_match():
    assert (dataclasses.asdict(config.FLConfig())
            == dataclasses.asdict(jconfig.FLConfig()))
    for n, c in ((100, 0.1), (10, 0.3), (7, 0.05), (20, 1.0)):
        kw = dict(nr_clients=n, client_fraction=c)
        assert (config.FLConfig(**kw).clients_per_round
                == jconfig.FLConfig(**kw).clients_per_round)


@pytest.mark.parametrize("args", [(10, 0, 0, 10), (10, 4, 57, 10),
                                  (0, 9, 99, 3), (42, 2, 1, 5)])
def test_per_client_seed_matches(args):
    assert rng.per_client_seed(*args) == jrng.per_client_seed(*args)
    g = rng.client_generator(*args)
    assert g.initial_seed() == jrng.per_client_seed(*args)


def test_sample_clients_without_replacement_and_reproducible():
    for r in range(5):
        a = rng.sample_clients(10, r, 100, 10)
        assert a.dtype == torch.int64 and a.shape == (10,)
        assert len(set(a.tolist())) == 10 and 0 <= a.min() and a.max() < 100
        # A round's draw does not depend on the rounds drawn before it.
        assert torch.equal(a, rng.sample_clients(10, r, 100, 10))
    assert not torch.equal(rng.sample_clients(10, 0, 100, 10),
                           rng.sample_clients(10, 1, 100, 10))


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_mnist_is_byte_identical(seed):
    got = mnist.synthetic_mnist(500, 120, seed=seed)
    want = jmnist.synthetic_mnist(500, 120, seed=seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _write_idx(path, array, gz):
    header = struct.pack(">i", 0x0800 | array.ndim) + struct.pack(
        ">" + "i" * array.ndim, *array.shape)
    data = header + array.astype(np.uint8).tobytes()
    if gz:
        with gzip.open(str(path) + ".gz", "wb") as f:
            f.write(data)
    else:
        path.write_bytes(data)


@pytest.mark.parametrize("gz", [False, True])
def test_load_mnist_reads_idx_files_as_the_jax_loader(tmp_path, gz):
    x, y, xt, yt = jmnist.synthetic_mnist(40, 10, seed=5)
    for stem, arr in (("train-images-idx3-ubyte", x),
                      ("train-labels-idx1-ubyte", y),
                      ("t10k-images-idx3-ubyte", xt),
                      ("t10k-labels-idx1-ubyte", yt)):
        _write_idx(tmp_path / stem, arr, gz)
    got = mnist.load_mnist(str(tmp_path))
    want = jmnist.load_mnist(str(tmp_path))
    for a, b, src in zip(got, want, (x, y, xt, yt)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, src)


def test_load_mnist_falls_back_to_the_synthetic_set(tmp_path):
    got = mnist.load_mnist(str(tmp_path / "none"), n_train=60, n_test=20)
    for a, b in zip(got, jmnist.synthetic_mnist(60, 20, seed=0)):
        np.testing.assert_array_equal(a, b)


def test_normalize_is_identical():
    x = mnist.synthetic_mnist(64, 1, seed=1)[0]
    got, want = mnist.normalize(x), jmnist.normalize(x)
    assert got.dtype == want.dtype == np.float32 and got.shape == (64, 1, 28, 28)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("iid", [True, False])
@pytest.mark.parametrize("nr_clients", [10, 7])
def test_split_is_identical(iid, nr_clients):
    y = mnist.synthetic_mnist(1000, 1, seed=0)[1]
    got = mnist.split(y, nr_clients, iid=iid, seed=10)
    want = jmnist.split(y, nr_clients, iid=iid, seed=10)
    assert len(got) == len(want) == nr_clients
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("iid", [True, False])
def test_federate_is_identical(iid):
    x_raw, y, _, _ = mnist.synthetic_mnist(1000, 1, seed=0)
    x = mnist.normalize(x_raw)
    subsets = mnist.split(y, 7, iid=iid, seed=10)      # ragged: 143 / 142
    got = federate(x, y, subsets, device="cpu")
    want = jfederate(x, y.astype(np.int32), subsets)
    assert got.nr_clients == want.nr_clients == 7
    assert got.y.dtype == torch.int64 and got.sample_counts.dtype == torch.int64
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.sample_counts.numpy(),
                                  np.asarray(want.sample_counts))
    assert got.mask.sum(1).tolist() == [len(s) for s in subsets]


@pytest.mark.parametrize("n, fraction, seed", [(100, 0.2, 0), (100, 0.2, 7),
                                               (10, 0.5, 1), (10, 0.2, 1)])
def test_injection_mask_is_identical(n, fraction, seed):
    got = attacks.injection_mask(n, fraction, seed)
    want = np.asarray(jattacks.injection_mask(n, fraction, seed))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == int(fraction * n)


def test_metrics_match():
    r = np.random.default_rng(0)
    logits = r.normal(size=(200, 10)).astype(np.float32)
    labels = r.integers(0, 10, 200)
    trig = r.integers(0, 10, 200)
    pred = logits.argmax(-1)
    assert metrics.accuracy(torch.from_numpy(logits), labels) == \
        jmetrics.accuracy(logits, labels)
    np.testing.assert_array_equal(
        metrics.confusion_matrix(torch.from_numpy(pred), labels, 10),
        jmetrics.confusion_matrix(pred, labels, 10))
    for label in (0, 3):
        assert metrics.backdoor_metrics(pred, labels, trig, label) == \
            jmetrics.backdoor_metrics(pred, labels, trig, label)
    same = np.zeros(5, int)
    assert metrics.backdoor_metrics(same, same, same, 0) == \
        jmetrics.backdoor_metrics(same, same, same, 0)
    for r_idx, m in ((0, 3), (4, 10)):
        assert metrics.message_count(r_idx, m) == \
            jmetrics.message_count(r_idx, m)


def test_run_result_records_and_renders_like_the_jax_one():
    args = ("fedavg", 100, 0.1, -1, 1, 0.01, 10)
    a, b = metrics.RunResult(*args), jmetrics.RunResult(*args)
    for r in range(3):
        a.record_round(0.5 + r, metrics.message_count(r, 10), 0.1 * r)
        b.record_round(0.5 + r, jmetrics.message_count(r, 10), 0.1 * r)
    assert a.rounds == b.rounds == 3
    assert a.as_df().equals(b.as_df())
    assert a.as_df()["B"].iloc[0] == "∞"
