"""Declarative evaluation specs: the param-space language and the
metric specs of the fleet evaluation.

Counterpart of the JAX package's ``evalfleet/specs.py``, the same
language and the same numbers. The space is data, a JSON spec that goes
through the job queue to the shard workers:

    {
      "variant": { ... engine.json ... },
      "axes": [
        {"path": "algorithms.0.params.lambda_", "values": [0.1, 1.0]},
        {"path": "algorithms.0.params.alpha",
         "range": {"from": 0.01, "to": 10.0, "steps": 4, "scale": "log"}}
      ],
      "metric": {"name": "map@5"},
      "otherMetrics": [{"name": "precision@5"}],
      "folds": 2
    }

An axis is a dot-path into the variant (integer segments index lists);
the points are the cross product of the axes, axis-major. `group_points`
buckets the points that can train over one staging per fold
(``Engine._grid_batchable``'s rule: one algorithm of one name, the other
stages equal), so a group is one ``train_grid`` a fold in its shard.

Metrics resolve from names (map@k, precision@k, ndcg@k, rmse) or from
an import path ({"class": "pkg.mod.Metric", "params": {...}}).
`metric_partial` turns a shard's (Q, P, A) tuples into a (sum, count)
pair, and the pairs of every fold combine to the sequential
MetricEvaluator's score of an averaging metric (its mean over all folds
is total sum / total count). No torch here: the eval driver and the records
run on hosts that train nothing.
"""

from __future__ import annotations

import copy
import itertools
import json
import math
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

from predictionio_tpu_torch.controller.metrics import (
    AverageMetric,
    EvalData,
    Metric,
    OptionAverageMetric,
    QPAMetric,
)

# variant keys that parameterize DASE stages — the only keys axes may
# target and the shape of the winner fragment fed back into retrains
STAGE_KEYS = ("datasource", "preparator", "algorithms", "serving")


# ---------------------------------------------------------------------------
# ranking / regression metrics (reusing the controller Metric family)
# ---------------------------------------------------------------------------


def _get(obj: Any, name: str, default: Any = None) -> Any:
    if isinstance(obj, dict):
        return obj.get(name, default)
    return getattr(obj, name, default)


class RankingMetric(AverageMetric):
    """Base for top-k ranking metrics: the Prediction carries a ranked
    item list under `pred_attr` (plain ids, (id, score) pairs, or dicts
    with an "item" key), the Actual carries the relevant set under
    `actual_attr`."""

    def __init__(self, k: int = 10, pred_attr: str = "items",
                 actual_attr: str = "items"):
        self.k = int(k)
        if self.k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        self.pred_attr = pred_attr
        self.actual_attr = actual_attr

    def header(self) -> str:
        return f"{type(self).__name__}@{self.k}"

    def _ranked(self, p: Any) -> list:
        items = _get(p, self.pred_attr) or ()
        out = []
        for it in items:
            if isinstance(it, (tuple, list)) and it:
                out.append(it[0])
            elif isinstance(it, dict) and "item" in it:
                out.append(it["item"])
            else:
                out.append(it)
        return out[: self.k]

    def _relevant(self, a: Any) -> set:
        return set(self._ranked_raw(_get(a, self.actual_attr) or ()))

    @staticmethod
    def _ranked_raw(items: Any) -> list:
        out = []
        for it in items:
            if isinstance(it, (tuple, list)) and it:
                out.append(it[0])
            elif isinstance(it, dict) and "item" in it:
                out.append(it["item"])
            else:
                out.append(it)
        return out


class PrecisionAtK(RankingMetric):
    """|top-k ∩ relevant| / min(k, |retrieved|); NaN when nothing was
    retrieved (NaN loses best-params selection, see Metric.compare)."""

    def calculate_one(self, q, p, a) -> float:
        ranked = self._ranked(p)
        if not ranked:
            return float("nan")
        rel = self._relevant(a)
        return sum(1 for i in ranked if i in rel) / float(len(ranked))


class MAPAtK(RankingMetric):
    """Mean average precision truncated at k (reference e2
    MeanAveragePrecisionAtK)."""

    def calculate_one(self, q, p, a) -> float:
        ranked = self._ranked(p)
        rel = self._relevant(a)
        if not rel:
            return float("nan")
        hits, ap = 0, 0.0
        for pos, item in enumerate(ranked):
            if item in rel:
                hits += 1
                ap += hits / float(pos + 1)
        return ap / float(min(len(rel), self.k))


class NDCGAtK(RankingMetric):
    """Binary-relevance normalized discounted cumulative gain at k."""

    def calculate_one(self, q, p, a) -> float:
        ranked = self._ranked(p)
        rel = self._relevant(a)
        if not rel:
            return float("nan")
        dcg = sum(
            1.0 / math.log2(pos + 2)
            for pos, item in enumerate(ranked) if item in rel
        )
        idcg = sum(
            1.0 / math.log2(pos + 2) for pos in range(min(len(rel), self.k))
        )
        return dcg / idcg if idcg > 0 else float("nan")


class HeldOutRMSE(QPAMetric):
    """Root mean squared error over held-out (prediction, actual) value
    pairs; lower is better. Carries its own combinable partial (sum of
    squared errors) so cross-shard reduction stays exact — a mean of
    per-fold RMSEs would NOT equal the pooled RMSE."""

    higher_is_better = False

    def __init__(self, pred_attr: str = "rating",
                 actual_attr: str = "rating"):
        self.pred_attr = pred_attr
        self.actual_attr = actual_attr

    def header(self) -> str:
        return "HeldOutRMSE"

    def calculate_one(self, q, p, a) -> float:
        pv, av = _get(p, self.pred_attr), _get(a, self.actual_attr)
        if pv is None or av is None:
            return float("nan")
        return (float(pv) - float(av)) ** 2

    def calculate(self, ctx, data: EvalData) -> float:
        part = self.partial(ctx, data)
        return self.finalize(part["sum"], part["count"])

    def partial(self, ctx, data: EvalData) -> dict:
        sqe = [
            s for _, qpa in data for q, p, a in qpa
            if not math.isnan(s := self.calculate_one(q, p, a))
        ]
        return {"sum": float(sum(sqe)), "count": len(sqe)}

    def finalize(self, total: float, count: int) -> float:
        return math.sqrt(total / count) if count else float("nan")


METRIC_REGISTRY: dict[str, type] = {
    "precision": PrecisionAtK,
    "map": MAPAtK,
    "ndcg": NDCGAtK,
    "rmse": HeldOutRMSE,
}


def resolve_metric(spec: Any) -> Metric:
    """Metric spec → Metric instance.

    Accepts "map@5", {"name": "map@5"}, {"name": "map", "k": 5,
    "pred_attr": ...}, or the escape hatch {"class": "pkg.mod.Cls",
    "params": {...}} for project-defined metrics."""
    if isinstance(spec, Metric):
        return spec
    if isinstance(spec, str):
        spec = {"name": spec}
    if not isinstance(spec, dict):
        raise ValueError(f"metric spec must be a name or dict, got {spec!r}")
    if "class" in spec:
        from predictionio_tpu_torch.controller.params import load_symbol

        cls = load_symbol(spec["class"])
        return cls(**spec.get("params", {}))
    name = spec.get("name", "")
    kwargs = {k: v for k, v in spec.items() if k != "name"}
    if "@" in name:
        name, _, k = name.partition("@")
        kwargs.setdefault("k", int(k))
    cls = METRIC_REGISTRY.get(name.lower())
    if cls is None:
        raise ValueError(
            f"unknown metric {name!r} (known: {sorted(METRIC_REGISTRY)}; "
            f"or pass {{'class': 'pkg.mod.Metric'}})"
        )
    if cls is HeldOutRMSE:
        kwargs.pop("k", None)
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# combinable partials — the cross-shard reduction contract
# ---------------------------------------------------------------------------


def metric_partial(metric: Metric, ctx, data: EvalData) -> dict:
    """One shard's contribution as a combinable {"sum", "count"} pair.

    Exact for the averaging family (per-tuple score sums) and for any
    metric exposing its own `partial`; other metrics degrade to a
    per-fold score with count 1 (the combined value is then a mean of
    fold scores — documented approximation)."""
    part = getattr(metric, "partial", None)
    if callable(part):
        out = part(ctx, data)
        return {"sum": float(out["sum"]), "count": int(out["count"])}
    if isinstance(metric, OptionAverageMetric):
        scores = [
            s for _, qpa in data for q, p, a in qpa
            if (s := metric.calculate_one(q, p, a)) is not None
        ]
    elif isinstance(metric, AverageMetric):
        scores = [
            metric.calculate_one(q, p, a) for _, qpa in data for q, p, a in qpa
        ]
    else:
        score = metric.calculate(ctx, data)
        return {"sum": float(score), "count": 1}
    scores = [s for s in scores if not (isinstance(s, float) and math.isnan(s))]
    return {"sum": float(sum(scores)), "count": len(scores)}


def metric_finalize(metric: Metric, total: float, count: int) -> float:
    """Combined (sum, count) → final score."""
    fin = getattr(metric, "finalize", None)
    if callable(fin):
        return float(fin(total, count))
    return float(total) / count if count else float("nan")


def combine_partials(parts: Sequence[dict]) -> tuple[float, int]:
    total = sum(float(p.get("sum", 0.0)) for p in parts)
    count = sum(int(p.get("count", 0)) for p in parts)
    return total, count


# ---------------------------------------------------------------------------
# param-space DSL
# ---------------------------------------------------------------------------


@dataclass
class ParamAxis:
    """One searched field: a dot-path into the variant + explicit values
    (ranges are expanded at parse time so the spec round-trips as data)."""

    path: str
    values: list

    def to_dict(self) -> dict:
        return {"path": self.path, "values": list(self.values)}

    @staticmethod
    def from_dict(obj: dict) -> "ParamAxis":
        path = obj.get("path", "")
        if not path or path.split(".", 1)[0] not in STAGE_KEYS:
            raise ValueError(
                f"axis path must target a stage key {STAGE_KEYS}, got {path!r}"
            )
        if "values" in obj:
            values = list(obj["values"])
        elif "range" in obj:
            values = _expand_range(obj["range"])
        else:
            raise ValueError(f"axis {path!r} needs 'values' or 'range'")
        if not values:
            raise ValueError(f"axis {path!r} expands to no values")
        return ParamAxis(path=path, values=values)


def _expand_range(r: dict) -> list:
    lo, hi = float(r["from"]), float(r["to"])
    steps = int(r.get("steps", 2))
    if steps < 1:
        raise ValueError(f"range steps must be >= 1, got {steps}")
    if steps == 1:
        return [lo]
    if r.get("scale", "linear") == "log":
        if lo <= 0 or hi <= 0:
            raise ValueError("log-scale range needs positive endpoints")
        ratio = (hi / lo) ** (1.0 / (steps - 1))
        return [lo * ratio ** i for i in range(steps)]
    step = (hi - lo) / (steps - 1)
    return [lo + step * i for i in range(steps)]


@dataclass
class EvalSpec:
    """The full declarative evaluation: base variant + axes + metrics.

    `folds > 0` shards the run per fold as well as per group — the
    datasource's read_eval must then yield exactly that many eval sets;
    0 means each shard evaluates all folds in one go."""

    variant: dict
    axes: list = field(default_factory=list)
    metric: Any = field(default_factory=lambda: {"name": "map@10"})
    other_metrics: list = field(default_factory=list)
    folds: int = 0

    def __post_init__(self):
        if not isinstance(self.variant, dict) or "engineFactory" not in self.variant:
            raise ValueError("spec variant must be an engine.json dict "
                             "with an engineFactory")
        if self.folds < 0:
            raise ValueError(f"folds must be >= 0, got {self.folds}")

    def to_dict(self) -> dict:
        return {
            "variant": self.variant,
            "axes": [a.to_dict() for a in self.axes],
            "metric": self.metric,
            "otherMetrics": list(self.other_metrics),
            "folds": self.folds,
        }

    @staticmethod
    def from_dict(obj: dict) -> "EvalSpec":
        return EvalSpec(
            variant=obj.get("variant") or {},
            axes=[ParamAxis.from_dict(a) for a in obj.get("axes", [])],
            metric=obj.get("metric") or {"name": "map@10"},
            other_metrics=list(obj.get("otherMetrics", [])),
            folds=int(obj.get("folds", 0)),
        )

    @staticmethod
    def load(path: str) -> "EvalSpec":
        with open(path) as f:
            return EvalSpec.from_dict(json.load(f))


def _set_path(variant: dict, path: str, value: Any) -> None:
    """Write `value` at a dot-path; integer segments index lists, missing
    dict segments are created (e.g. an algorithm entry without params)."""
    node: Any = variant
    segs = path.split(".")
    for i, seg in enumerate(segs):
        last = i == len(segs) - 1
        if isinstance(node, list):
            idx = int(seg)
            if idx >= len(node):
                raise ValueError(
                    f"axis path {path!r}: index {idx} out of range "
                    f"({len(node)} entries)"
                )
            if last:
                node[idx] = value
            else:
                node = node[idx]
        elif isinstance(node, dict):
            if last:
                node[seg] = value
            else:
                if seg not in node or node[seg] is None:
                    node[seg] = {}
                node = node[seg]
        else:
            raise ValueError(
                f"axis path {path!r}: segment {seg!r} lands on a scalar"
            )


def expand_points(spec: EvalSpec) -> list[dict]:
    """Cross product of all axes applied to deep copies of the base
    variant; deterministic axis-major order (point 0 = first value of
    every axis). No axes → the single base point."""
    if not spec.axes:
        return [copy.deepcopy(spec.variant)]
    points = []
    for combo in itertools.product(*(a.values for a in spec.axes)):
        v = copy.deepcopy(spec.variant)
        for axis, value in zip(spec.axes, combo):
            _set_path(v, axis.path, value)
        points.append(v)
    return points


def point_fragment(point_variant: dict) -> dict:
    """The stage-params fragment of a point — what EvalResult records
    store and what the tuning loop overlays onto retrain variants (same
    shape as MetricEvaluatorResult._params_dict)."""
    return {k: copy.deepcopy(point_variant[k])
            for k in STAGE_KEYS if k in point_variant}


def _group_key(point: dict) -> str:
    """Grid-kernel compatibility key, mirroring Engine._grid_batchable:
    points sharing a single same-named algorithm and identical
    datasource/preparator/serving configs can train as one device
    program per fold via train_grid. (train_grid availability is checked
    at shard runtime — Engine.batch_eval degrades to the serial path.)"""
    algos = point.get("algorithms") or []
    if len(algos) != 1:
        return "solo:" + json.dumps(point, sort_keys=True, default=str)
    shared = {k: point.get(k) for k in ("datasource", "preparator", "serving")}
    shared["algo_name"] = algos[0].get("name", "")
    return "grid:" + json.dumps(shared, sort_keys=True, default=str)


def group_points(points: Sequence[dict]) -> list[list[int]]:
    """Point indices bucketed by grid compatibility, order-preserving."""
    groups: dict[str, list[int]] = {}
    for i, p in enumerate(points):
        groups.setdefault(_group_key(p), []).append(i)
    return list(groups.values())
