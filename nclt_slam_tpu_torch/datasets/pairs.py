"""UTM-threshold pair mining for place-recognition training
(``nclt_slam_tpu/datasets/pairs.py``; the reference's NCLT Kaggle protocol,
datasets/nclt_kaggle/src/datasets/nclt_pairs.py:243-330 and
configs/dataset_config.yaml:33-39):

- the session-date split registry (train 4 / val 2 / test 4 sessions);
- per anchor, the CLOSEST pose within ``positive_threshold`` (10 m, the
  anchor itself excluded) is the positive, and ``num_negatives`` (5) are
  drawn uniformly from the poses beyond ``negative_threshold`` (25 m);
  anchors without a positive or with too few negatives are dropped;
- hard-negative mining in descriptor space (the k nearest candidates).

Mining is host numpy, the JAX package's code as it is (the same
``default_rng`` draws, so the same triples); the epoch batches are numpy
index arrays; hard negatives and the pair loss run on tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# session split registry (dataset_config.yaml:33-35)
TRAIN_SESSIONS = ("2012-01-08", "2012-01-22", "2012-02-12", "2012-02-18")
VAL_SESSIONS = ("2012-03-31", "2012-05-26")
TEST_SESSIONS = ("2012-08-04", "2012-10-28", "2012-11-04", "2012-12-01")

POSITIVE_THRESHOLD_M = 10.0
NEGATIVE_THRESHOLD_M = 25.0
NUM_NEGATIVES = 5


def sessions_for_split(split: str) -> tuple[str, ...]:
    try:
        return {"train": TRAIN_SESSIONS, "val": VAL_SESSIONS,
                "test": TEST_SESSIONS}[split]
    except KeyError:
        raise ValueError(f"Invalid split '{split}' "
                         "(must be train/val/test)") from None


class MinedPairs(NamedTuple):
    anchor: np.ndarray     # (M,) indices into the pose array
    positive: np.ndarray   # (M,)
    negatives: np.ndarray  # (M, num_negatives)


def mine_pairs(coords: np.ndarray,
               positive_threshold: float = POSITIVE_THRESHOLD_M,
               negative_threshold: float = NEGATIVE_THRESHOLD_M,
               num_negatives: int = NUM_NEGATIVES,
               seed: int = 42, block: int = 512) -> MinedPairs:
    """Mine (anchor, closest-positive, random-negatives) index triples.

    coords: (N, 3) pose positions (UTM / world).  Positives strictly within
    the threshold excluding self, the CLOSEST one chosen; negatives sampled
    without replacement beyond the negative threshold; anchors lacking
    either are skipped."""
    coords = np.asarray(coords, np.float64)
    N = len(coords)
    rng = np.random.default_rng(seed)
    anchors, positives, negatives = [], [], []

    for s in range(0, N, block):
        blk = coords[s:s + block]                        # (B, 3)
        d = np.linalg.norm(blk[:, None, :] - coords[None, :, :], axis=-1)
        d[np.arange(len(blk)), s + np.arange(len(blk))] = np.inf  # self
        pos_ok = d < positive_threshold
        has_pos = pos_ok.any(axis=1)
        best_pos = np.argmin(np.where(pos_ok, d, np.inf), axis=1)
        # isfinite: the self-distance was poisoned to inf above, which
        # would otherwise pass the > threshold test
        neg_ok = (d > negative_threshold) & np.isfinite(d)

        for i in np.where(has_pos)[0]:
            neg_idx = np.where(neg_ok[i])[0]
            if len(neg_idx) < num_negatives:
                continue
            anchors.append(s + i)
            positives.append(best_pos[i])
            negatives.append(rng.choice(neg_idx, size=num_negatives,
                                        replace=False))

    if not anchors:
        return MinedPairs(np.zeros(0, np.int32), np.zeros(0, np.int32),
                          np.zeros((0, num_negatives), np.int32))
    return MinedPairs(np.asarray(anchors, np.int32),
                      np.asarray(positives, np.int32),
                      np.stack(negatives).astype(np.int32))


def _norm(x):
    """Euclidean norm over the last axis, as ``jnp.linalg.norm`` forms it."""
    return torch.sqrt((x * x).sum(-1))


def hard_negatives(anchor_desc, cand_desc, k: int):
    """Descriptor-space hard-negative mining (nclt_pairs.py:307-330):
    anchor_desc (B, D), cand_desc (B, C, D) -> (B, k) indices of the k
    nearest (= hardest) candidates per anchor.  Equal distances keep the
    lower index first, as ``jax.lax.top_k`` does: the first k of a stable
    ascending sort."""
    d = _norm(cand_desc - anchor_desc[:, None, :])
    return torch.argsort(d, dim=-1, stable=True)[:, :k]


def pairs_epoch_batches(pairs: MinedPairs, batch: int, seed: int = 0):
    """Shuffle mined pairs and yield fixed-shape index batches (the ragged
    tail is dropped)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pairs.anchor))
    for s in range(0, len(order) - batch + 1, batch):
        sel = order[s:s + batch]
        yield (pairs.anchor[sel], pairs.positive[sel], pairs.negatives[sel])


def triplet_loss_pairs(emb_a, emb_p, emb_n, margin: float = 0.5):
    """Triplet margin loss over mined pairs with in-batch hard mining:
    emb_a/emb_p (B, D), emb_n (B, K, D).  The hardest (nearest) negative
    per anchor drives the hinge.  ``amin`` and ``maximum`` split the
    gradient of a tie evenly, as JAX's ``min`` and ``maximum`` do."""
    d_pos = _norm(emb_a - emb_p)
    d_neg = _norm(emb_n - emb_a[:, None, :]).amin(-1)
    hinge = margin + d_pos - d_neg
    return torch.maximum(hinge, torch.zeros_like(hinge)).mean()
