"""Linear (ridge) regression: the normal equations' sufficient
statistics on the card, the solve on the host.

Counterpart of the JAX package's ``models/linreg.py`` (reference
examples/experimental/scala-parallel-regression/Run.scala:62-64, MLlib
LinearRegressionWithSGD): XᵀX (D×D) and Xᵀy (D) as two full-f32
matrix products on the device (``ops.segment.full_f32``: TF32 off
whatever the process set), then the centring and a float64
``np.linalg.solve`` on the host, as in the JAX package. A grid of l2
values shares one statistics pass. Prediction is numpy on the host; a
model holds no tensor and no device.

The products are taken about the f32 column means (the data shifted by
them on the device) and the raw sums rebuilt from them in float64. The
JAX package takes them unshifted, so its float64 centring
XᵀX − n·μμᵀ, Xᵀy − n·μ·ȳ cancels the f32 rounding of sums about zero,
which loses digits where a mean is large against its spread (a target
in years, ȳ ≈ 2,000). The statistics and every step after them are
the JAX package's. The statistics pass is instrumented for
``obs.devprof`` as ``linreg.normal_eq_terms``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.obs import costs, devprof
from predictionio_tpu_torch.ops.segment import full_f32


@dataclass
class LinearRegressionModel:
    weights: np.ndarray  # (D,)
    intercept: float

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.atleast_2d(np.asarray(x, np.float32))
        return x @ self.weights + self.intercept


def _normal_eq_terms(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """Weighted XᵀX, Xᵀy, Σw, Σw·x and Σw·y in float64 numpy, from f32
    products on the tensors' device about the weighted column means c
    (and c_y): with x' = x − c, y' = y − c_y,
    XᵀWX = X'ᵀWX' + c·(Σw·x')ᵀ + (Σw·x')·cᵀ + Σw·c·cᵀ, and alike for
    XᵀWy, Σw·x and Σw·y."""
    with full_f32():
        n = w.sum()
        c = (w @ x) / n
        c_y = (w @ y) / n
        xs = x - c
        ys = y - c_y
        xw = xs * w[:, None]
        xtx_s = xw.T @ xs
        xty_s = xw.T @ ys
        sx_s = xw.sum(0)
        sy_s = (w * ys).sum()
    xtx_s, xty_s, sx_s, c = (t.double().cpu().numpy() for t in (xtx_s, xty_s, sx_s, c))
    n, sy_s, c_y = float(n), float(sy_s), float(c_y)
    xtx = xtx_s + np.outer(c, sx_s) + np.outer(sx_s, c) + n * np.outer(c, c)
    xty = xty_s + c * sy_s + c_y * sx_s + n * c * c_y
    return xtx, xty, n, sx_s + n * c, sy_s + n * c_y


def _terms_cost(args, kwargs) -> costs.Work:
    """XᵀX and Xᵀy about the means, the means and the shifts."""
    n, d = int(args[0].shape[0]), int(args[0].shape[1])
    return (costs.matmul(d, d + 1, n)
            + costs.Work({"f32": 8.0 * n * d}, float(3 * n * d * 4)))


_normal_eq_terms = devprof.instrument("linreg.normal_eq_terms", _normal_eq_terms,
                                      cost=_terms_cost, dtype_of=lambda a, kw: "f32")


def _center_stats(xtx, xty, n, xsum, ysum, fit_intercept):
    """Fold the intercept by centering the sufficient statistics:
    (X−μ)ᵀ(X−μ) = XᵀX − n μμᵀ, (X−μ)ᵀ(y−ȳ) = Xᵀy − n μ ȳ."""
    mu = xsum / n
    ybar = ysum / n
    if fit_intercept:
        xtx = xtx - np.outer(mu, mu) * n
        xty = xty - mu * ybar * n
    return xtx, xty, mu, ybar


def _stats(x, y, device):
    """The centred statistics of (x, y) at unit weights, from one pass on
    `device` (the first CUDA device when None)."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    xt = torch.tensor(x, device=dev)
    yt = torch.tensor(y, device=dev)
    return x.shape[1], _normal_eq_terms(xt, yt, torch.ones(len(x), dtype=torch.float32,
                                                            device=dev))


def _solve(xtx, xty, n, mu, ybar, d, l2, fit_intercept) -> LinearRegressionModel:
    weights = np.linalg.solve(xtx + float(l2) * n * np.eye(d), xty).astype(np.float32)
    intercept = float(ybar - mu @ weights) if fit_intercept else 0.0
    return LinearRegressionModel(weights=weights, intercept=intercept)


def train_linear_regression(
    x: np.ndarray,
    y: np.ndarray,
    l2: float = 1e-6,
    fit_intercept: bool = True,
    device=None,
) -> LinearRegressionModel:
    d, (xtx, xty, n, xsum, ysum) = _stats(x, y, device)
    xtx, xty, mu, ybar = _center_stats(xtx, xty, n, xsum, ysum, fit_intercept)
    return _solve(xtx, xty, n, mu, ybar, d, l2, fit_intercept)


def train_linear_regression_grid(
    x: np.ndarray,
    y: np.ndarray,
    l2_grid,
    fit_intercept: bool = True,
    device=None,
) -> list[LinearRegressionModel]:
    """The whole l2 grid from ONE statistics pass (the only O(N) device
    work); each grid point is a D×D solve."""
    d, (xtx, xty, n, xsum, ysum) = _stats(x, y, device)
    xtx, xty, mu, ybar = _center_stats(xtx, xty, n, xsum, ysum, fit_intercept)
    return [_solve(xtx, xty, n, mu, ybar, d, l2, fit_intercept) for l2 in l2_grid]
