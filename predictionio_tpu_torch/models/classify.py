"""Multinomial naive Bayes and softmax logistic regression on the card.

Counterpart of the JAX package's ``models/classify.py`` (reference
classification template's MLlib ``NaiveBayes.train(lambda)`` and its
second algorithm). Both train over one (N, D) feature matrix on the
device, as torch ops (no kernel of the port's own): naive Bayes is one
label-indexed sum pass, logistic regression a full-batch gradient loop.
Every product runs in full f32 (``ops.segment.full_f32``), as the JAX
package's ``Precision.HIGHEST``, and in a fixed order: the label sums
are a one-hot matrix product, not a scatter with atomics, so a train
gives the same bits on every launch.

A grid trains in one pass too: naive Bayes shares the label sums across
its λ values; logistic regression carries a (D+1, G·C) weight matrix,
so each step is one set of launches for all G points (the JAX package
vmaps them).

Models keep numpy arrays, pickle without a device, and score on the
device `bind_device` gives them (``DeviceModel``).
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.segment import full_f32


class DeviceModel:
    """A model's arrays (numpy, its persisted state, named by `_ARRAYS`)
    staged once on the model's device for prediction. Pickles its
    arrays, never its device or staged tensors; an unpickled model has
    no device until `bind_device` gives it the deploy's."""

    _ARRAYS: tuple[str, ...] = ()

    @property
    def n_features(self) -> int:
        """The width of a row the model scores."""
        raise NotImplementedError

    def _init_device(self, device) -> None:
        self.device = resolve_device(device)
        self._staged: Optional[dict] = None
        self._stage_lock = threading.Lock()

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items()
                if k not in ("device", "_staged", "_stage_lock")}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.device = None  # bound by the deploy (bind_device)
        self._staged = None
        self._stage_lock = threading.Lock()

    def bind_device(self, device=None) -> None:
        """Serve on `device` (the first CUDA device when None), dropping
        any state staged elsewhere."""
        with self._stage_lock:
            self.device = resolve_device(device)
            self._staged = None

    def staged(self) -> dict:
        """The arrays as tensors on the model's device, staged once under
        the stage lock (concurrent batches must not double-stage)."""
        with self._stage_lock:
            if self.device is None:
                raise RuntimeError(
                    f"the model has no device: an unpickled model is bound by "
                    f"prepare_deploy ({type(self).__name__}.bind_device)"
                )
            if self._staged is None:
                self._staged = {k: _tensor(getattr(self, k), self.device)
                                for k in self._ARRAYS}
            return self._staged

    def _rows(self, x) -> torch.Tensor:
        return _tensor(np.atleast_2d(np.asarray(x, np.float32)), self.device)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """A copy of `a` on `device` (`a` may be a read-only view)."""
    return torch.tensor(np.ascontiguousarray(a), device=device)


def _on(device, *arrays):
    dev = resolve_device(device)
    return dev, [_tensor(a, dev) for a in arrays]


# ---------------------------------------------------------------------------
# Multinomial naive Bayes (MLlib NaiveBayes parity: additive smoothing)
# ---------------------------------------------------------------------------


class NaiveBayesModel(DeviceModel):
    _ARRAYS = ("log_prior", "log_likelihood")

    def __init__(self, log_prior: np.ndarray, log_likelihood: np.ndarray, device=None):
        self.log_prior = np.asarray(log_prior, np.float32)  # (C,)
        self.log_likelihood = np.asarray(log_likelihood, np.float32)  # (C, D)
        self._init_device(device)

    @property
    def n_features(self) -> int:
        return self.log_likelihood.shape[1]

    def predict_scores(self, x: np.ndarray) -> np.ndarray:
        """(B, C) log joint scores."""
        t = self.staged()
        with full_f32():
            s = self._rows(x) @ t["log_likelihood"].T + t["log_prior"]
        return s.cpu().numpy()

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.predict_scores(x).argmax(axis=-1)  # the first maximal class


def _label_sums(x, y, w, n_classes):
    """Σw and Σw·x per label as one-hot products in a fixed order: (C,),
    (C, D)."""
    onehot = torch.nn.functional.one_hot(y, n_classes).to(x.dtype)
    return onehot.T @ w, onehot.T @ (x * w[:, None])


def _nb_smooth(class_count, feat_sum, total, lam, d):
    """log P(class) and the smoothed log P(feature | class); `lam` a
    float or a (G, 1, 1) tensor of grid values."""
    log_prior = torch.log(class_count) - torch.log(total)
    log_like = torch.log(feat_sum + lam) - torch.log(
        feat_sum.sum(-1, keepdim=True) + lam * d
    )
    return log_prior, log_like


def _nb_inputs(x, y, device):
    x = np.asarray(x, dtype=np.float32)
    y = np.asarray(y, dtype=np.int64)
    if (x < 0).any():
        raise ValueError("multinomial NB requires non-negative features")
    dev, (xt, yt) = _on(device, x, y)
    return dev, xt, yt, torch.ones(len(x), dtype=torch.float32, device=dev)


def train_naive_bayes(
    x: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    lam: float = 1.0,
    device=None,
) -> NaiveBayesModel:
    """x must be non-negative (multinomial counts / binary indicators)."""
    dev, xt, yt, w = _nb_inputs(x, y, device)
    with full_f32():
        class_count, feat_sum = _label_sums(xt, yt, w, n_classes)
        log_prior, log_like = _nb_smooth(class_count, feat_sum, w.sum(), lam, xt.shape[1])
    return NaiveBayesModel(log_prior.cpu().numpy(), log_like.cpu().numpy(), device=dev)


def train_naive_bayes_grid(
    x: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    lams: Sequence[float],
    device=None,
) -> list[NaiveBayesModel]:
    """The whole smoothing grid over one label-sum pass; the per-λ
    smoothing is batched."""
    dev, xt, yt, w = _nb_inputs(x, y, device)
    lam_t = torch.tensor(list(lams), dtype=torch.float32, device=dev)[:, None, None]
    with full_f32():
        class_count, feat_sum = _label_sums(xt, yt, w, n_classes)
        log_prior, log_like = _nb_smooth(class_count, feat_sum[None], w.sum(), lam_t,
                                         xt.shape[1])
    log_prior, log_like = log_prior.cpu().numpy(), log_like.cpu().numpy()
    return [NaiveBayesModel(log_prior, log_like[g], device=dev) for g in range(len(lams))]


# ---------------------------------------------------------------------------
# Softmax (multinomial) logistic regression — full-batch gradient descent
# ---------------------------------------------------------------------------


class LogisticRegressionModel(DeviceModel):
    _ARRAYS = ("weights",)

    def __init__(self, weights: np.ndarray, device=None):
        self.weights = np.asarray(weights, np.float32)  # (D+1, C); the last row is the bias
        self._init_device(device)

    @property
    def n_features(self) -> int:
        return self.weights.shape[0] - 1

    def predict_scores(self, x: np.ndarray) -> np.ndarray:
        w = self.staged()["weights"]
        with full_f32():
            s = self._rows(x) @ w[:-1] + w[-1]
        return s.cpu().numpy()

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.predict_scores(x).argmax(axis=-1)  # the first maximal class


def _standardize(x: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Center + scale so a fixed lr is stable across datasets — an
    uncentered mean component inflates the top Hessian eigenvalue past
    2/lr and GD amplifies float noise geometrically; the affine map folds
    back into the returned weights via _fold_back_standardization."""
    mu = x.mean(axis=0).astype(np.float32)
    std = x.std(axis=0)
    std = np.where(std > 0, std, 1.0).astype(np.float32)
    return (x - mu) / std, mu, std


def _fold_back_standardization(w, mu, std) -> np.ndarray:
    scaled = w[:-1] / std[:, None]
    bias = w[-1:] - (mu / std) @ w[:-1]
    return np.concatenate([scaled, bias], axis=0)


def _lr_train_body(x, y, wt, lrs, l2s, *, n_classes: int, iterations: int):
    """Gradient descent from zero weights for G (lr, l2) points at once:
    (N, D) x, (N,) labels, (N,) row weights, (G,) lrs and l2s → (G, D+1,
    C) weights. The gradient of the weighted mean cross-entropy plus
    0.5·l2·|W[:-1]|² in closed form: for each point, the logits' is
    (softmax − one_hot(y))·wt/Σwt."""
    n, d = x.shape
    g_pts = lrs.shape[0]
    y1h = torch.nn.functional.one_hot(y, n_classes).to(x.dtype)
    coef = (wt / wt.sum())[:, None, None]
    lr = lrs[None, :, None]
    l2 = l2s[None, :, None]
    w = torch.zeros((d + 1, g_pts, n_classes), dtype=x.dtype, device=x.device)
    with full_f32():
        for _ in range(iterations):
            logits = (x @ w[:-1].reshape(d, -1)).reshape(n, g_pts, n_classes) + w[-1]
            g = (torch.softmax(logits, dim=-1) - y1h[:, None, :]) * coef
            grad_w = (x.T @ g.reshape(n, -1)).reshape(d, g_pts, n_classes) + l2 * w[:-1]
            grad_b = g.sum(0)
            w = w - lr * torch.cat([grad_w, grad_b[None]], dim=0)
    return w.permute(1, 0, 2)


def _lr_grid(x, y, n_classes, grid, iterations, normalize, device):
    x = np.asarray(x, dtype=np.float32)
    y = np.asarray(y, dtype=np.int64)
    if normalize:
        x, mu, std = _standardize(x)
    dev, (xt, yt) = _on(device, x, y)
    wt = torch.ones(len(x), dtype=torch.float32, device=dev)
    lrs = torch.tensor([g[0] for g in grid], dtype=torch.float32, device=dev)
    l2s = torch.tensor([g[1] for g in grid], dtype=torch.float32, device=dev)
    ws = _lr_train_body(xt, yt, wt, lrs, l2s, n_classes=n_classes,
                        iterations=iterations).cpu().numpy()
    out = []
    for w in ws:
        if normalize:
            w = _fold_back_standardization(w, mu, std)
        out.append(LogisticRegressionModel(w, device=dev))
    return out


def train_logistic_regression(
    x: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    iterations: int = 200,
    lr: float = 0.5,
    l2: float = 1e-4,
    normalize: bool = True,
    device=None,
) -> LogisticRegressionModel:
    return _lr_grid(x, y, n_classes, [(lr, l2)], iterations, normalize, device)[0]


def train_logistic_regression_grid(
    x: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    grid: Sequence[tuple[float, float]],  # (lr, l2) per point
    iterations: int = 200,
    normalize: bool = True,
    device=None,
) -> list[LogisticRegressionModel]:
    """The whole (lr, l2) grid as one batched gradient loop."""
    return _lr_grid(x, y, n_classes, list(grid), iterations, normalize, device)
