"""Random forest classification on the card (histogram trees).

Counterpart of the JAX package's ``models/forest.py`` (reference
classification template's MLlib RandomForest, add-algorithm
RandomForestAlgorithm.scala: numTrees / maxDepth / maxBins and per-node
feature subsets). The same design, as torch ops (no kernel of the
port's own):

- features are quantile-binned once on the host to int codes;
- trees grow breadth-first to a static depth, every level's 2^level
  nodes at once, and all T trees together;
- a level's work is a class-weighted histogram (T, D, nodes, bins, C),
  then the best (feature, bin) per node by Gini gain, the first maximal
  index on ties (an all-invalid node gains -inf everywhere and takes
  index 0, a leaf);
- early-stopped nodes route every sample left, so their subtree collapses
  into one leaf at the bottom level;
- leaf class distributions are smoothed toward the global prior.

The grower (``grow_forest``) is a pure function of its random draws: the
(T, N) Poisson(1) bootstrap weights and, per level, the (T, 2^level, D)
uniforms behind the feature masks. ``train_random_forest`` draws them
from a ``torch.Generator`` seeded with `seed` on the train's device. The
JAX package draws with threefry (``jax.random``), so one seed grows other
trees in the two packages; fed the JAX package's draws, the grower gives
its trees.

Every sum the split choice reads is exact or taken in a fixed order, so
the card and the CPU grow the same trees from the same draws: histogram
cells add integer weights (Poisson count x one-hot label), exact in f32
below 2^24 in any order of the scatter's atomics; cumulative sums of
them are integers too; the per-class sums of squares and of leaf counts
add the C classes one by one. Prediction averages the trees' leaf
distributions by adding them in tree order, so a model answers with the
same bits on either device. The grower and the prediction are
instrumented for ``obs.devprof`` as ``forest.train`` and
``forest.predict``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.models.classify import DeviceModel
from predictionio_tpu_torch.obs import costs, devprof

# ---------------------------------------------------------------------------
# Host-side quantile binning
# ---------------------------------------------------------------------------


def make_bin_edges(x: np.ndarray, n_bins: int) -> np.ndarray:
    """(D, n_bins-1) per-feature quantile edges."""
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    return np.quantile(x, qs, axis=0).T.astype(np.float32)


def binize(x: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """(N, D) float features → int32 bin codes in [0, n_bins)."""
    out = np.empty(x.shape, np.int32)
    for d in range(x.shape[1]):
        out[:, d] = np.searchsorted(edges[d], x[:, d], side="right")
    return out


# ---------------------------------------------------------------------------
# The grower: all trees at once, one level at a time
# ---------------------------------------------------------------------------

# index entries a histogram scatter takes at once (the int64 keys of
# T·N·features rows of a chunk of features)
HIST_CHUNK = 1 << 26


def _class_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ over the last (class) axis, the classes added one by one: the
    same bits on every device."""
    acc = t[..., 0]
    for c in range(1, t.shape[-1]):
        acc = acc + t[..., c]
    return acc


def _feature_mask(r: Optional[torch.Tensor], n_nodes: int, n_feat: int, k: int, n_trees: int,
                  device) -> torch.Tensor:
    """(T, n_nodes, D) bool: exactly the k features with the smallest of
    each node's uniforms `r` (the RF featureSubsetStrategy analogue); all
    of them when k >= D."""
    if k >= n_feat:
        return torch.ones((n_trees, n_nodes, n_feat), dtype=torch.bool, device=device)
    kth = torch.topk(r, k, dim=-1, largest=False).values[..., -1]
    return r <= kth[..., None]


def _histograms(xbin, w, y, node, n_nodes: int, n_bins: int, n_classes: int):
    """(T, D, n_nodes, n_bins, C) sums of the bootstrap weights by (tree,
    feature, node, bin, label). Each cell adds integer weights, so the
    scatter's atomics, in whatever order, give exact sums below 2^24."""
    n_trees, n = w.shape
    d = xbin.shape[1]
    cells = n_nodes * n_bins * n_classes
    hist = torch.zeros(n_trees * d * cells, dtype=torch.float32, device=w.device)
    # (T, N): the cell of each sample in its tree, before the feature's
    tree_node = (torch.arange(n_trees, device=w.device)[:, None] * d * n_nodes
                 + node) * n_bins
    step = max(1, HIST_CHUNK // max(1, n_trees * n))
    for f0 in range(0, d, step):
        f = torch.arange(f0, min(d, f0 + step), device=w.device)
        keys = ((tree_node[:, :, None] + f * (n_nodes * n_bins)
                 + xbin[None, :, f0:f0 + len(f)]) * n_classes + y[None, :, None])
        hist.index_add_(0, keys.reshape(-1), w[:, :, None].expand(-1, -1, len(f)).reshape(-1))
    return hist.reshape(n_trees, d, n_nodes, n_bins, n_classes)


def _best_splits(hist, feat_mask, min_child_weight: float, n_bins: int):
    """Per node of each tree the best (feature, bin) by Gini impurity
    decrease: (feature or -1 for a leaf, routing feature, routing
    threshold), each (T, n_nodes); leaves route everything left
    (threshold n_bins)."""
    n_trees, d, n_nodes, _, _ = hist.shape
    eps = 1e-12
    left = torch.cumsum(hist, dim=3)  # counts with bin <= b
    tot = left[:, 0, :, -1, :]  # (T, nodes, C): the same for every feature
    right = tot[:, None, :, None, :] - left
    nl = _class_sum(left)
    nr = _class_sum(right)  # (T, D, nodes, B)
    child = (nl - _class_sum(left * left) / torch.clamp(nl, min=eps)) + (
        nr - _class_sum(right * right) / torch.clamp(nr, min=eps))
    n_tot = _class_sum(tot)  # (T, nodes)
    parent = n_tot - _class_sum(tot * tot) / torch.clamp(n_tot, min=eps)
    gain = parent[:, None, :, None] - child
    invalid = ((nl < min_child_weight) | (nr < min_child_weight)
               | ~feat_mask.transpose(1, 2)[..., None])
    gain = torch.where(invalid, torch.full_like(gain, -torch.inf), gain)
    flat = gain.permute(0, 2, 1, 3).reshape(n_trees, n_nodes, d * n_bins)
    best = torch.argmax(flat, dim=-1)  # the first maximal index
    best_gain = torch.gather(flat, -1, best[..., None])[..., 0]
    feat = best // n_bins
    thr = best % n_bins
    is_leaf = ~(best_gain > 0.0)  # no positive gain (or all invalid)
    feature = torch.where(is_leaf, -1, feat)
    feat_route = torch.where(is_leaf, 0, feat)
    thr_route = torch.where(is_leaf, n_bins, thr)
    return feature, feat_route, thr_route


def _route(xbin, node, feat_route, thr_route):
    """Each sample's child in every tree: (T, N) node ids at the next
    level."""
    f = torch.gather(feat_route, 1, node)
    t = torch.gather(thr_route, 1, node)
    xsel = xbin[torch.arange(xbin.shape[0], device=xbin.device)[None, :], f]
    return node * 2 + (xsel > t).to(node.dtype)


def _leaf_proba(w, y, node, n_leaves: int, n_classes: int):
    """(T, n_leaves, C) class distributions of each tree's leaves,
    smoothed toward the global prior so a reachable-but-empty leaf
    predicts sanely."""
    n_trees = w.shape[0]
    keys = ((torch.arange(n_trees, device=w.device)[:, None] * n_leaves + node) * n_classes
            + y[None, :])
    counts = torch.zeros(n_trees * n_leaves * n_classes, dtype=torch.float32, device=w.device)
    counts.index_add_(0, keys.reshape(-1), w.reshape(-1))  # integer sums: exact
    label_count = torch.bincount(y, minlength=n_classes).to(torch.float32)
    prior = label_count / torch.clamp(label_count.sum(), min=1.0)
    counts = counts.reshape(n_trees, n_leaves, n_classes) + 1e-3 * prior
    return counts / _class_sum(counts)[..., None]


def grow_forest(
    xbin: torch.Tensor,
    y: torch.Tensor,
    boot_weights: torch.Tensor,
    level_uniforms: Sequence[Optional[torch.Tensor]],
    *,
    n_classes: int,
    n_bins: int,
    feat_per_node: int,
    min_child_weight: float,
):
    """Grow T trees from their random draws, on the tensors' device.

    xbin (N, D) int64 bin codes, y (N,) int64 labels, boot_weights (T, N)
    f32 (Poisson(1) counts times the row's validity), level_uniforms one
    (T, 2^level, D) f32 tensor per level (None where feat_per_node >= D).
    The depth is the number of levels. Returns features, routes_f,
    routes_t (T, depth, 2^(depth-1)) int32 and leaf_proba (T, 2^depth, C)
    f32."""
    n_trees, n = boot_weights.shape
    d = xbin.shape[1]
    depth = len(level_uniforms)
    max_nodes = 2 ** (depth - 1)
    dev = xbin.device
    node = torch.zeros((n_trees, n), dtype=torch.int64, device=dev)
    features = torch.full((n_trees, depth, max_nodes), -1, dtype=torch.int64, device=dev)
    routes_f = torch.zeros((n_trees, depth, max_nodes), dtype=torch.int64, device=dev)
    routes_t = torch.full((n_trees, depth, max_nodes), n_bins, dtype=torch.int64, device=dev)
    for level, r in enumerate(level_uniforms):
        n_nodes = 2 ** level
        mask = _feature_mask(r, n_nodes, d, feat_per_node, n_trees, dev)
        hist = _histograms(xbin, boot_weights, y, node, n_nodes, n_bins, n_classes)
        feature, feat_route, thr_route = _best_splits(hist, mask, min_child_weight, n_bins)
        del hist
        node = _route(xbin, node, feat_route, thr_route)
        features[:, level, :n_nodes] = feature
        routes_f[:, level, :n_nodes] = feat_route
        routes_t[:, level, :n_nodes] = thr_route
    proba = _leaf_proba(boot_weights, y, node, 2 ** depth, n_classes)
    return (features.to(torch.int32), routes_f.to(torch.int32), routes_t.to(torch.int32),
            proba)


def _grow_cost(args, kwargs) -> costs.Work:
    """Per level, a key and an `index_add_` a (tree, row, feature) into
    the histograms, the split search over them and the routing."""
    xbin, boot, levels = args[0], args[2], args[3]
    (t, n), d, depth = boot.shape, int(xbin.shape[1]), len(levels)
    cells = t * n * d
    hist = sum(t * 2 ** lv * d * kwargs["n_bins"] * kwargs["n_classes"] for lv in range(depth))
    return costs.Work({"f32": 4.0 * cells * depth + 8.0 * hist},
                      float(n * d * 8 + cells * depth * 20 + hist * 8))


grow_forest = devprof.instrument("forest.train", grow_forest, cost=_grow_cost,
                                 dtype_of=lambda a, kw: "f32")


def draw_forest(n_trees: int, n: int, d: int, depth: int, feat_per_node: int, seed: int,
                device) -> tuple[torch.Tensor, list[Optional[torch.Tensor]]]:
    """The grower's random draws from one ``torch.Generator`` seeded with
    `seed` on `device`: the (T, N) Poisson(1) bootstrap counts, then each
    level's (T, 2^level, D) uniforms (None where every feature is kept)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    boot = torch.poisson(torch.ones((n_trees, n), dtype=torch.float32, device=device),
                         generator=gen)
    uniforms = [
        None if feat_per_node >= d else
        torch.rand((n_trees, 2 ** level, d), generator=gen, device=device)
        for level in range(depth)
    ]
    return boot, uniforms


# ---------------------------------------------------------------------------
# Prediction and the public model
# ---------------------------------------------------------------------------


def predict_forest(routes_f, routes_t, proba, xbin, depth: int) -> torch.Tensor:
    """(N, C) the trees' leaf distributions averaged, added in tree
    order."""
    n_trees = routes_f.shape[0]
    node = torch.zeros((n_trees, xbin.shape[0]), dtype=torch.int64, device=xbin.device)
    for level in range(depth):
        node = _route(xbin, node, routes_f[:, level].long(), routes_t[:, level].long())
    acc = proba[0][node[0]]
    for t in range(1, n_trees):
        acc = acc + proba[t][node[t]]
    return acc / n_trees


def _predict_cost(args, kwargs) -> costs.Work:
    routes_f, proba, xbin, depth = args[0], args[2], args[3], args[4]
    t, b, c = int(routes_f.shape[0]), int(xbin.shape[0]), int(proba.shape[-1])
    return costs.Work({"f32": 2.0 * t * b * (depth + c)},
                      float(b * xbin.shape[1] * 8 + t * b * depth * 16 + b * c * 4))


predict_forest = devprof.instrument("forest.predict", predict_forest, cost=_predict_cost,
                                    dtype_of=lambda a, kw: "f32")


class RandomForestModel(DeviceModel):
    _ARRAYS = ("routes_f", "routes_t", "leaf_proba")

    def __init__(self, bin_edges, features, routes_f, routes_t, leaf_proba, depth: int,
                 device=None):
        self.bin_edges = np.asarray(bin_edges, np.float32)  # (D, n_bins-1)
        self.features = np.asarray(features, np.int32)  # (T, depth, max_nodes), -1 = leaf
        self.routes_f = np.asarray(routes_f, np.int32)  # routing feature
        self.routes_t = np.asarray(routes_t, np.int32)  # routing bin threshold
        self.leaf_proba = np.asarray(leaf_proba, np.float32)  # (T, 2^depth, C)
        self.depth = int(depth)
        self._init_device(device)

    @property
    def n_features(self) -> int:
        return self.bin_edges.shape[0]

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        xbin = binize(np.atleast_2d(np.asarray(x, np.float32)), self.bin_edges)
        t = self.staged()
        xb = torch.from_numpy(xbin.astype(np.int64)).to(self.device)
        return predict_forest(t["routes_f"], t["routes_t"], t["leaf_proba"], xb,
                              self.depth).cpu().numpy()

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.predict_proba(x).argmax(axis=-1)  # the first maximal class


def feat_per_node_of(d: int, feature_fraction: Optional[float]) -> int:
    """Features tried at a node: round(sqrt(D)) by default (the RF "auto"
    strategy for classification), else round(feature_fraction · D)."""
    if feature_fraction is None:
        return max(1, int(round(np.sqrt(d))))
    return max(1, min(d, int(round(feature_fraction * d))))


def train_random_forest(
    x: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    n_trees: int = 20,
    max_depth: int = 6,
    n_bins: int = 32,
    feature_fraction: Optional[float] = None,
    min_child_weight: float = 1.0,
    seed: int = 0,
    device=None,
) -> RandomForestModel:
    """Train a histogram random forest on `device` (the first CUDA device
    when None), its draws from a generator seeded with `seed` there."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int64)
    n, d = x.shape
    edges = make_bin_edges(x, n_bins)
    xbin = torch.tensor(binize(x, edges).astype(np.int64), device=dev)
    yt = torch.tensor(y, device=dev)
    k = feat_per_node_of(d, feature_fraction)
    boot, uniforms = draw_forest(n_trees, n, d, max_depth, k, seed, dev)
    features, routes_f, routes_t, proba = grow_forest(
        xbin, yt, boot, uniforms, n_classes=n_classes, n_bins=n_bins, feat_per_node=k,
        min_child_weight=min_child_weight,
    )
    return RandomForestModel(
        bin_edges=edges, features=features.cpu().numpy(), routes_f=routes_f.cpu().numpy(),
        routes_t=routes_t.cpu().numpy(), leaf_proba=proba.cpu().numpy(), depth=max_depth,
        device=dev,
    )
