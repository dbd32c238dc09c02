"""The port's secure aggregation against the JAX package's on the CPU at
``tests/test_fl.py``'s size: the fixed-point grid (round half to even)
equal, the pairwise masks cancelling bitwise in the int32 ring even where
the masked sums wrap, one masked upload spread over the whole ring, the
capacity check raising where the JAX one does, and a secure round within
one quantum (``secagg_scale``) per coordinate of the JAX server's with
the same clients sampled and dropout off. Tolerances are stated at each
check."""

import jax
import numpy as np
import pytest
import torch

from ddl25spring_tpu import fl as jfl
from ddl25spring_tpu.config import FLConfig as JFLConfig
from ddl25spring_tpu.data import mnist as jmnist
from ddl25spring_tpu.fl import secure_agg as jsec
from ddl25spring_tpu.models import mnist_cnn as jcnn
from ddl25spring_tpu_torch import convert, fl, rng
from ddl25spring_tpu_torch.config import FLConfig
from ddl25spring_tpu_torch.fl import secure_agg as sec
from ddl25spring_tpu_torch.fl.privacy import DPFedAvgServer
from ddl25spring_tpu_torch.models import mnist_cnn
from ddl25spring_tpu_torch.tree import tree_index, tree_leaves, tree_map

torch.set_num_threads(1)

CFG = dict(nr_clients=10, client_fraction=0.3, batch_size=50, epochs=1,
           lr=0.05, rounds=2, seed=10)
FIXED = [np.array([1, 4, 7]), np.array([0, 2, 9])]
CLIP, BITS = 5.0, 20
QUANTUM = sec.secagg_scale(CLIP, BITS)


@pytest.fixture(scope="module")
def setup():
    x_raw, y, xt_raw, yt = jmnist.load_mnist(n_train=1000, n_test=300, seed=0)
    x, xt = jmnist.normalize(x_raw), jmnist.normalize(xt_raw)
    subsets = jmnist.split(y, CFG["nr_clients"], iid=True, seed=CFG["seed"])
    jparams = jcnn.init(jax.random.key(0))
    return dict(xt=xt, yt=yt, jdata=jfl.federate(x, y.astype(np.int32),
                                                 subsets),
                data=fl.federate(x, y, subsets, device="cpu"),
                jparams=jparams, params=convert.mnist_params_from_jax(
                    jax.tree.map(np.asarray, jparams), device="cpu"))


def _server(s, **kw):
    return sec.SecureAggFedAvgServer(
        s["params"], lambda p, x: mnist_cnn.apply(p, x), s["data"], s["xt"],
        s["yt"], FLConfig(**CFG), device="cpu", clip_norm=CLIP, bits=BITS,
        **kw)


def test_quantize_matches_bitwise_with_ties():
    scale = 0.25
    x = np.concatenate([np.arange(-20, 21) * scale / 2,          # exact halves
                        np.random.default_rng(0).standard_normal(500)]
                       ).astype(np.float32)
    got = sec.quantize_tree({"w": torch.from_numpy(x)}, scale)["w"]
    want = jsec.quantize_tree({"w": x}, scale)["w"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        sec.dequantize_tree({"w": got}, scale)["w"].numpy(),
        np.asarray(jsec.dequantize_tree({"w": want}, scale)["w"]))
    assert sec.secagg_scale(CLIP, BITS) == jsec.secagg_scale(CLIP, BITS)


def test_pairwise_masks_cancel_bitwise_where_they_wrap():
    """Three clients with quantized values near the int32 limits: their
    masked uploads wrap the ring, and the wrapped sum of the uploads
    equals the wrapped sum of the values exactly."""
    r = np.random.default_rng(0)
    gids = [2, 5, 9]
    trees = [{"w": torch.from_numpy(r.integers(2**31 - 40, 2**31, 64)
                                    .astype(np.int32)),
              "b": [torch.from_numpy(r.integers(-2**31, -2**31 + 40, 7)
                                     .astype(np.int32))]} for _ in gids]
    uploads = [sec.add_pair_masks(t, g, gids, [True] * 3, 1234, 0)
               for t, g in zip(trees, gids)]
    stack = lambda ts: tree_map(lambda *u: torch.stack(u), *ts)
    masked, plain = sec.ring_sum(stack(uploads)), sec.ring_sum(stack(trees))
    for a, b in zip(tree_leaves(masked), tree_leaves(plain)):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    # The plain sum itself wraps: 3 values near 2^31 leave [−2^31, 2^31).
    raw = sum(t["w"].to(torch.int64) for t in trees)
    assert bool((raw >= 2**31).all())
    # A mask of one pair is the same from both ends, and an invalid or
    # self pair adds nothing.
    same = sec.add_pair_masks(trees[0], 2, [2, 5], [True, False], 1234, 0)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(same),
                                                 tree_leaves(trees[0])))


def test_single_masked_upload_spans_the_ring():
    t = {"w": torch.zeros(4096, dtype=torch.int32)}
    m = sec.add_pair_masks(t, 1, [1, 3], [True, True], 7, 0)["w"].double()
    assert float(m.abs().max()) > 1e9
    assert abs(float(m.std()) - 2**32 / 12**0.5) / (2**32 / 12**0.5) < 0.05
    drawn = sec.mask_tree(sec.pair_generator(7, 3, 1, 0, "cpu"), t)["w"]
    again = sec.mask_tree(sec.pair_generator(7, 1, 3, 0, "cpu"), t)["w"]
    assert torch.equal(drawn, again)


@pytest.mark.parametrize("bits,m", [(20, 10), (20, 2047), (20, 2048),
                                    (16, 32767), (16, 32768), (30, 1),
                                    (30, 2), (1, 2), (31, 2), (2, 10)])
def test_capacity_check_raises_where_the_jax_one_does(bits, m):
    def raised(fn):
        try:
            fn(bits, m)
        except ValueError:
            return True
        return False
    assert raised(sec.check_secagg_capacity) == \
        raised(jsec.check_secagg_capacity)


def test_secure_round_within_one_quantum_of_the_jax_server(setup):
    s = setup
    js = jsec.SecureAggFedAvgServer(s["jparams"], lambda p, x, key=None:
                                    jcnn.apply(p, x), s["jdata"], s["xt"],
                                    s["yt"].astype(np.int32),
                                    JFLConfig(**CFG), clip_norm=CLIP,
                                    bits=BITS)
    ts = _server(s)
    js._sample = ts._sample = lambda r: FIXED[r]
    with torch.no_grad():
        got = ts._round(ts.params, 0)
    want = js._round(js.params, 0)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        err = float(np.abs(a.numpy() - np.asarray(b)).max())
        assert err <= QUANTUM, (np.shape(b), err)


def test_masked_sum_equals_the_quantized_sum_and_the_clipped_round(setup):
    """The server's masked sum is the unmasked ring sum bitwise; the
    round is the plain clipped (DP at z = 0) round within half a quantum
    per client per coordinate, averaged: at most one quantum."""
    s = setup
    ts = _server(s)
    plain = DPFedAvgServer(s["params"], lambda p, x: mnist_cnn.apply(p, x),
                           s["data"], s["xt"], s["yt"], FLConfig(**CFG),
                           clip_norm=CLIP, noise_multiplier=0.0,
                           device="cpu")
    with torch.no_grad():
        idx, q = ts.quantized_deltas(ts.params, 0)
        masked = ts.masked_sum(idx, q, 0)
        unmasked = sec.ring_sum(q)
        for a, b in zip(tree_leaves(masked), tree_leaves(unmasked)):
            assert torch.equal(a, b)
        # One client's upload alone is not its quantized delta.
        one = sec.add_pair_masks(tree_index(q, 0), int(idx[0]), idx,
                                 [True] * len(idx), ts.mask_root, 0)
        assert not torch.equal(tree_leaves(one)[0], tree_leaves(q)[0][0])
        got = sec.finish_secagg_round(ts.params, masked, ts._scale, len(idx))
        want = plain._round(plain.params, 0)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert float((a - b).abs().max()) <= QUANTUM


def test_masked_upload_is_one_clients_view(setup):
    """``masked_upload`` per client (its own local SGD, clip, quantize,
    masks): the uploads' ring sum equals bitwise the ring sum of the same
    clients' uploads with every pair marked invalid (no masks: the
    quantized deltas), and lies within one grid step per client of the
    server's masked sum (the server trains the clients at once, whose
    floats may round a step apart)."""
    s = setup
    ts = _server(s)
    d = s["data"]
    cfg = FLConfig(**CFG)
    idx = FIXED[0]

    def uploads(valid):
        out = []
        for gid in idx:
            gen = rng.client_generator(cfg.seed, 0, int(gid),
                                       cfg.clients_per_round)
            out.append(sec.masked_upload(
                ts.apply_fn, cfg, ts.params, d.x[gid], d.y[gid], d.mask[gid],
                gen, int(gid), idx, [valid] * 3, ts.mask_root, 0, CLIP,
                ts._scale))
        return sec.ring_sum(tree_map(lambda *u: torch.stack(u), *out))

    with torch.no_grad():
        total, plain = uploads(True), uploads(False)
        ts._sample = lambda r: idx
        _, q = ts.quantized_deltas(ts.params, 0)
        server_sum = ts.masked_sum(idx, q, 0)
    for a, b, c in zip(tree_leaves(total), tree_leaves(plain),
                       tree_leaves(server_sum)):
        assert torch.equal(a, b)
        assert int((a.to(torch.int64) - c.to(torch.int64)).abs().max()) \
            <= len(idx)


def test_secure_agg_learns(setup):
    server = fl.SecureAggFedAvgServer(
        setup["params"], mnist_cnn.apply, setup["data"], setup["xt"],
        setup["yt"], FLConfig(**CFG), device="cpu")
    before = server.test()
    res = server.run(3)
    assert res.algorithm == "secagg-fedavg"
    assert res.test_accuracy[-1] > before + 0.05
