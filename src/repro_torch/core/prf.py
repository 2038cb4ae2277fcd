"""Probabilistic-random-forest-lite surrogate (paper's black-box sampler,
PRF [33]) — a small bagged regression forest in pure numpy.

Used by the inner (para-topo) search when the strategy space is too large
to enumerate: fit on evaluated (features -> throughput) points, then rank
unevaluated candidates by UCB = mean + kappa * std across trees.
"""
from __future__ import annotations

import numpy as np


class _Tree:
    __slots__ = ("feat", "thresh", "left", "right", "value")

    def __init__(self):
        self.feat = -1
        self.value = 0.0
        self.left = self.right = None
        self.thresh = 0.0


def _build(x, y, rng, depth, max_depth, min_leaf, n_feat_try):
    node = _Tree()
    node.value = float(y.mean()) if len(y) else 0.0
    if depth >= max_depth or len(y) < 2 * min_leaf or np.ptp(y) < 1e-12:
        return node
    feats = rng.choice(x.shape[1], size=min(n_feat_try, x.shape[1]),
                       replace=False)
    best = (None, None, np.inf)
    for f in feats:
        vals = np.unique(x[:, f])
        if len(vals) < 2:
            continue
        cuts = (vals[:-1] + vals[1:]) / 2.0
        if len(cuts) > 8:
            cuts = rng.choice(cuts, size=8, replace=False)
        for c in cuts:
            m = x[:, f] <= c
            nl, nr = m.sum(), (~m).sum()
            if nl < min_leaf or nr < min_leaf:
                continue
            sse = (np.var(y[m]) * nl + np.var(y[~m]) * nr)
            if sse < best[2]:
                best = (f, c, sse)
    if best[0] is None:
        return node
    f, c, _ = best
    m = x[:, f] <= c
    node.feat, node.thresh = int(f), float(c)
    node.left = _build(x[m], y[m], rng, depth + 1, max_depth, min_leaf,
                       n_feat_try)
    node.right = _build(x[~m], y[~m], rng, depth + 1, max_depth, min_leaf,
                        n_feat_try)
    return node


def _predict_one(node, row):
    while node.feat >= 0:
        node = node.left if row[node.feat] <= node.thresh else node.right
    return node.value


class PRF:
    def __init__(self, n_trees=24, max_depth=6, min_leaf=2, seed=0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.rng = np.random.default_rng(seed)
        self.trees = []

    def fit(self, x, y):
        x = np.asarray(x, float)
        y = np.asarray(y, float)
        n = len(y)
        n_feat_try = max(1, int(np.sqrt(x.shape[1])))
        self.trees = []
        for _ in range(self.n_trees):
            idx = self.rng.integers(0, n, size=n)
            self.trees.append(_build(x[idx], y[idx], self.rng, 0,
                                     self.max_depth, self.min_leaf,
                                     n_feat_try))
        return self

    def predict(self, x, return_std=False):
        x = np.asarray(x, float)
        preds = np.array([[_predict_one(t, row) for t in self.trees]
                          for row in x])
        mean = preds.mean(1)
        if return_std:
            return mean, preds.std(1)
        return mean

    def ucb(self, x, kappa=1.0):
        m, s = self.predict(x, return_std=True)
        return m + kappa * s
