"""The place-recognition learning path (``datasets/pairs.py``,
``datasets/models/place_recognition.py``, ``eval/metrics.py:pr_curve`` /
``average_precision``) against the JAX package, from the same seeded
inputs, keys and carried parameters.

Bit-equal: pair mining and the epoch batches (the same numpy code),
hard negatives with tied distances (``lax.top_k``'s lower-index order),
``voxelize`` (truncation toward zero kept), ``recall_at_k`` with tied
distances, the precision/recall curve.  By tolerance: ``init_params``
(a normal draw is within four ulps of JAX's), ``embed`` from carried
parameters (1e-5: three convolutions and GeM pooling in float32 sum in
other orders), the losses and their gradients with tied distances (1e-6),
one SGD step (1e-5).  The JAX package's two training tests are redone on
the port with its thresholds.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from test_datasets import _two_session_loop, ring_scan  # noqa: E402

from nclt_slam_tpu.datasets import pairs as JP  # noqa: E402
from nclt_slam_tpu.datasets.models import place_recognition as J  # noqa: E402
from nclt_slam_tpu.eval import metrics as JM  # noqa: E402
from nclt_slam_tpu_torch import interop  # noqa: E402
from nclt_slam_tpu_torch.core import prng  # noqa: E402
from nclt_slam_tpu_torch.datasets import pairs as TP  # noqa: E402
from nclt_slam_tpu_torch.datasets.models import place_recognition as T  # noqa: E402
from nclt_slam_tpu_torch.eval import average_precision, pr_curve  # noqa: E402

torch.set_num_threads(1)

EMBED_ATOL = 1e-5
GRAD_ATOL = 1e-6
STEP_ATOL = 1e-5


def t(x):
    return torch.from_numpy(np.asarray(x))


def test_mine_pairs_and_epoch_batches_are_bit_equal():
    coords, _ = _two_session_loop()
    jp = JP.mine_pairs(coords, block=37)     # a block that splits the loop
    tp = TP.mine_pairs(coords, block=37)
    assert len(tp.anchor) > 0
    for a, b in zip(jp, tp):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for seed in range(3):
        jb = list(JP.pairs_epoch_batches(jp, 16, seed=seed))
        tb = list(TP.pairs_epoch_batches(tp, 16, seed=seed))
        assert len(tb) == len(jb) == len(tp.anchor) // 16
        for x, y in zip(jb, tb):
            assert all(np.array_equal(u, v) for u, v in zip(x, y))
    assert TP.sessions_for_split("test") == JP.sessions_for_split("test")
    with pytest.raises(ValueError):
        TP.sessions_for_split("dev")
    back = interop.to_numpy_tree(interop.from_numpy_tree(jp, "cpu"))
    assert type(back).__name__ == "MinedPairs"
    assert all(np.array_equal(a, b) for a, b in zip(back, jp))


@pytest.mark.parametrize("k", [1, 3, 5])
def test_hard_negatives_with_ties_follow_top_k(k):
    rng = np.random.RandomState(0)
    anchor = rng.randn(4, 8).astype(np.float32)
    cand = rng.randn(4, 16, 8).astype(np.float32)
    # planted ties: equal candidates, the nearest among them
    cand[:, 9] = cand[:, 3] = cand[:, 12] = anchor + 0.01
    cand[1, 5] = cand[1, 1]
    j = np.asarray(JP.hard_negatives(jnp.asarray(anchor), jnp.asarray(cand),
                                     k))
    p = TP.hard_negatives(t(anchor), t(cand), k).numpy()
    assert np.array_equal(p, j)
    assert (p[:, 0] == 3).all()


def test_voxelize_is_bit_equal():
    rng = np.random.RandomState(1)
    cell = np.array([80 / 32, 80 / 32, 16 / 16], np.float32)
    pts = rng.uniform([-45, -45, -6], [45, 45, 14], (3, 600, 3)
                      ).astype(np.float32)
    # up to one cell below lo truncates into cell 0 and counts as inside
    pts[:, :3] = np.array([-40.0, -40.0, -4.0], np.float32) - 0.5 * cell
    pts[:, 3] = np.array([-40.0, 0.0, 0.0], np.float32) - 1.5 * cell
    valid = rng.rand(3, 600) < 0.9
    valid[:, :4] = True
    j = np.asarray(jax.vmap(J.voxelize)(jnp.asarray(pts), jnp.asarray(valid)))
    p = T.voxelize(t(pts), t(valid)).numpy()
    assert p.shape == (3, 32, 32, 16)
    assert np.array_equal(p, j)
    assert p[:, 0, 0, 0].all()
    single = T.voxelize(t(pts[1]), t(valid[1])).numpy()
    assert np.array_equal(single, j[1])


@pytest.fixture(scope="module")
def params():
    jp = J.init_params(jax.random.PRNGKey(3))
    return jp, interop.from_numpy_tree(jp, "cpu")


def test_init_params_and_embed(params):
    jp, tp = params
    own = T.init_params(prng.PRNGKey(3, "cpu"))
    for name, a, b in zip(jp._fields, jp, own):
        assert tuple(b.shape) == a.shape, name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6, err_msg=name)
    back = interop.to_numpy_tree(tp)
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(back, jp))
    rng = np.random.RandomState(2)
    grids = (rng.rand(6, 32, 32, 16) < 0.05).astype(np.float32)
    je = np.asarray(J.embed(jp, jnp.asarray(grids)))
    te = T.embed(tp, t(grids)).numpy()
    assert te.shape == (6, 128)
    np.testing.assert_allclose(te, je, rtol=0, atol=EMBED_ATOL)
    np.testing.assert_allclose(np.linalg.norm(te, axis=1), 1.0, atol=1e-5)


def tied_embeddings():
    """8 embeddings, 3 labels: anchor 0's two positives (1, 2) at equal
    distance, its nearest negatives (3, 4) equal too."""
    rng = np.random.RandomState(3)
    e = rng.randn(8, 16).astype(np.float32) * 0.3
    e[2] = e[1]
    e[4] = e[3] = e[0] + 0.05
    return e, np.array([0, 0, 0, 1, 1, 2, 2, 2], np.int32)


def test_batch_hard_loss_and_gradient_with_ties():
    e, labels = tied_embeddings()
    jl, jg = jax.value_and_grad(
        lambda x: J.triplet_loss_hard(x, jnp.asarray(labels)))(jnp.asarray(e))
    x = t(e).requires_grad_()
    tl = T.triplet_loss_hard(x, t(labels))
    (tg,) = torch.autograd.grad(tl, x)
    assert tl.item() > 0
    np.testing.assert_allclose(tl.item(), float(jl), rtol=0, atol=GRAD_ATOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=GRAD_ATOL)
    assert np.abs(tg[1].numpy()).max() > 0     # the tie's gradient is split
    np.testing.assert_allclose(tg[3].numpy(), tg[4].numpy(), atol=1e-7)


def test_pair_loss_and_gradient_with_ties():
    rng = np.random.RandomState(4)
    a = rng.randn(4, 16).astype(np.float32) * 0.3
    p = a + 0.2 * rng.randn(4, 16).astype(np.float32)
    n = rng.randn(4, 5, 16).astype(np.float32) * 0.3
    n[:, 1] = n[:, 3] = a + 0.1                 # tied hardest negatives

    def jloss(a, p, n):
        return JP.triplet_loss_pairs(a, p, n)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(a), jnp.asarray(p), jnp.asarray(n))
    xs = [t(v).requires_grad_() for v in (a, p, n)]
    tl = TP.triplet_loss_pairs(*xs)
    tg = torch.autograd.grad(tl, xs)
    assert tl.item() > 0
    np.testing.assert_allclose(tl.item(), float(jl), rtol=0, atol=GRAD_ATOL)
    for u, v in zip(tg, jg):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=0,
                                   atol=GRAD_ATOL)
    np.testing.assert_allclose(tg[2][:, 1].numpy(), tg[2][:, 3].numpy(),
                               atol=1e-7)


def test_one_train_step(params):
    jp, tp = params
    rng = np.random.RandomState(5)
    grids = (rng.rand(8, 32, 32, 16) < 0.04).astype(np.float32)
    labels = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
    jn, jl = J.train_step(jp, jnp.asarray(grids), jnp.asarray(labels),
                          lr=1e-2)
    tn, tl = T.train_step(tp, t(grids), t(labels), lr=1e-2)
    np.testing.assert_allclose(float(tl), float(jl), rtol=0, atol=EMBED_ATOL)
    for name, a, b in zip(jp._fields, jn, tn):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=STEP_ATOL, err_msg=name)
    moved = max(float((b - a).abs().max()) for a, b in zip(tp, tn))
    assert moved > 1e-4


@pytest.mark.parametrize("k", [1, 2, 3])
def test_recall_at_k_with_ties(k, monkeypatch):
    monkeypatch.setattr(T, "_QUERY_BLOCK", 3)     # two blocks of queries
    rng = np.random.RandomState(6)
    db = rng.randn(12, 8).astype(np.float32)
    db[5] = db[2]                    # equal db entries, different labels
    db[9] = db[2]
    db_labels = np.arange(12, dtype=np.int32) % 5
    q = db[[2, 3, 7, 9]] + 0.0
    q_labels = np.array([4, 3, 1, 0], np.int32)
    j = float(J.recall_at_k(jnp.asarray(q), jnp.asarray(db),
                            jnp.asarray(q_labels), jnp.asarray(db_labels), k))
    p = float(T.recall_at_k(t(q), t(db), t(q_labels), t(db_labels), k))
    assert p == j


def test_pr_curve_and_average_precision_are_bit_equal():
    rng = np.random.RandomState(7)
    scores = np.round(rng.rand(300), 2)     # many tied scores
    is_match = rng.rand(300) < 0.3
    for a, b in zip(pr_curve(scores, is_match),
                    JM.pr_curve(scores, is_match)):
        assert np.array_equal(a, b)
    assert average_precision(scores, is_match) == \
        JM.average_precision(scores, is_match)


def test_port_learns_places():
    """``tests/test_datasets.py::test_place_recognition_learns`` on the
    port: 4 places x 4 noisy revisits, 30 SGD steps."""
    rng = np.random.RandomState(6)
    params = T.init_params(prng.PRNGKey(0, "cpu"))
    scans, labels = [], []
    bases = [ring_scan(rng, radius=r) for r in (6.0, 10.0, 14.0, 18.0)]
    for li, base in enumerate(bases):
        for _ in range(4):
            scans.append(base + rng.normal(0, 0.1, base.shape))
            labels.append(li)
    grids = T.voxelize(t(np.stack(scans).astype(np.float32)),
                       torch.ones(16, 256, dtype=torch.bool))
    labels = torch.tensor(labels)
    loss0 = float(T.triplet_loss_hard(T.embed(params, grids), labels))
    for _ in range(30):
        params, loss = T.train_step(params, grids, labels, lr=3e-3)
    assert float(loss) < loss0
    emb = T.embed(params, grids)
    r1 = T.recall_at_k(emb[::4], emb, labels[::4], labels, k=2)
    assert float(r1) > 0.7


def test_port_learns_on_mined_pairs():
    """``tests/test_datasets.py::test_place_recognition_on_mined_pairs`` on
    the port: mined (anchor, positive, negatives) triples from a fixed
    world, Adam(1e-2), 3 epochs; Recall@1 of session-1 queries against the
    session-0 database within 10 m."""
    rng = np.random.RandomState(4)
    coords, session = _two_session_loop()
    ang = rng.uniform(0, 2 * np.pi, 160)
    r = rng.uniform(48.0, 75.0, 160)
    trees = np.stack([r * np.cos(ang), r * np.sin(ang)], -1)

    def scan_at(xy):
        rel = trees - xy[None, :2]
        near = np.argsort(np.hypot(*rel.T))[:48]
        z = np.linspace(0.2, 6.0, 6)
        pts = [np.stack([np.full(6, rel[n, 0]), np.full(6, rel[n, 1]), z],
                        -1) for n in near]
        return np.concatenate(pts) + rng.normal(0, 0.15, (48 * 6, 3))

    scans = np.stack([scan_at(c[:2]) for c in coords]).astype(np.float32)
    grids = T.voxelize(t(scans), torch.ones(scans.shape[:2],
                                             dtype=torch.bool))
    pairs = TP.mine_pairs(coords, seed=1)
    params = T.init_params(prng.PRNGKey(3, "cpu"))
    leaves = [p.clone().requires_grad_() for p in params]
    opt = torch.optim.Adam(leaves, lr=1e-2)
    losses = []
    for epoch in range(3):
        for a, p, n in TP.pairs_epoch_batches(pairs, batch=16, seed=epoch):
            B = len(a)
            idx = torch.from_numpy(np.concatenate([a, p, n.reshape(-1)]))
            e = T.embed(T.PRParams(*leaves), grids[idx.long()])
            loss = TP.triplet_loss_pairs(e[:B], e[B:2 * B],
                                         e[2 * B:].reshape(B, -1, e.shape[-1]))
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(float(loss))
    with torch.no_grad():
        emb = T.embed(T.PRParams(*leaves), grids)
    q, db = torch.from_numpy(session == 1), torch.from_numpy(session == 0)
    d = torch.sqrt(((emb[q][:, None] - emb[db][None]) ** 2).sum(-1))
    nn = d.argmin(1).numpy()
    geo = np.linalg.norm(coords[session == 1][:, None]
                         - coords[session == 0][None], axis=-1)
    hit = geo[np.arange(int(q.sum())), nn] < 10.0
    assert losses[-1] < losses[0]
    assert hit.mean() > 0.6, hit.mean()
    hn = TP.hard_negatives(emb[:4], emb[None, 4:20].expand(4, 16, 128), k=3)
    dd = np.linalg.norm(emb[:4].numpy()[:, None] - emb[4:20].numpy()[None],
                        axis=-1)
    for i in range(4):
        assert set(hn[i].tolist()) == set(np.argsort(dd[i])[:3].tolist())
