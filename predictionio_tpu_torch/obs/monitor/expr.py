"""Series algebra over the TSDB: a small expression parser and evaluator.

Counterpart of the JAX package's ``obs/monitor/expr.py``, the port's own
copy; the same texts parse, evaluate and fail alike. A PromQL-flavored
language evaluated against the ring buffers:

- instant selectors        ``up{instance="gw-1"}``
- range functions          ``rate(http_requests_total[5m])``,
                           ``increase(x[300s])``,
                           ``quantile_over_time(0.99, p99_ms[1h])``
                           (evaluated per series, unlike the TSDB's
                           summing methods)
- aggregation              ``sum by (instance) (...)``, also
                           ``mean|avg|max|min|count``, bare ``sum(...)``
- binary arithmetic        ``+ - * /`` with exact-label-set matching
                           between vectors and broadcast against scalars
- offset modifier          ``rate(http_requests_total[5m] offset 1h)``
                           shifts a selector's evaluation time into the
                           past, so that a binary operator compares one
                           window at two points in time. With a durable
                           tier the shifted window reads through to disk,
                           from the picked tier's points (reset-aware; a
                           downsampled tier gives each bucket's `last`).

Values are vectors (lists of ``(labels, value)`` samples) or scalars.
Division by zero drops the sample: a ratio with no denominator traffic
reads as no data, never as a spike.

Readers: ``RecordingRule(kind="expr")``, expression SLO specs, ``console
tsdb query '<expr>'``, ``console monitor --expr``, the dashboard's TSDB
explorer and ``GET /debug/tsdb?expr=``. Standard library only.
"""

from __future__ import annotations

import functools
import re
import time
from typing import Any, Optional, Union

from predictionio_tpu_torch.obs.monitor.tsdb import (
    TSDB,
    LabelPairs,
    increase_of,
    quantile_of,
)

__all__ = [
    "ExprError",
    "parse",
    "evaluate",
    "evaluate_rows",
    "DEFAULT_WINDOW_S",
]

DEFAULT_WINDOW_S = 300.0

#: aggregation operators usable as ``<agg> [by (l1, ...)] (expr)``
AGG_OPS = ("sum", "mean", "avg", "max", "min", "count")

#: range functions usable as ``<fn>(selector[window])``
RANGE_FNS = ("rate", "increase", "quantile_over_time")

# result model: a scalar float, or a vector of (label-pairs, value)
Vector = list[tuple[LabelPairs, float]]
Value = Union[float, Vector]


class ExprError(ValueError):
    """Raised on syntax or type errors in a series expression."""


# -- tokenizer ---------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<num>\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
  | (?P<ident>[A-Za-z_:][A-Za-z0-9_:.]*)
  | (?P<str>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<op>[+\-*/(){}\[\],=])
  | (?P<ws>\s+)
    """,
    re.VERBOSE,
)

_DURATION_RE = re.compile(r"^(\d+(?:\.\d+)?)(ms|s|m|h|d)?$")
_DURATION_UNITS = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0,
                   "d": 86400.0, None: 1.0}


def _tokenize(text: str) -> list[tuple[str, str]]:
    tokens: list[tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ExprError(
                f"unexpected character {text[pos]!r} at position {pos}"
            )
        pos = m.end()
        kind = m.lastgroup or ""
        if kind == "ws":
            continue
        tokens.append((kind, m.group()))
    return tokens


# -- AST ---------------------------------------------------------------------


class _Node:
    def eval(self, ctx: "_Ctx") -> Optional[Value]:
        raise NotImplementedError


class _Number(_Node):
    def __init__(self, value: float):
        self.value = value

    def eval(self, ctx: "_Ctx") -> Optional[Value]:
        return self.value


class _Selector(_Node):
    """``name{k="v",...}`` with an optional ``[window]`` range suffix
    and an optional ``offset <duration>`` modifier."""

    def __init__(self, name: str, match: dict[str, str],
                 window_s: Optional[float], offset_s: float = 0.0):
        self.name = name
        self.match = match
        self.window_s = window_s
        self.offset_s = offset_s

    def eval(self, ctx: "_Ctx") -> Optional[Value]:
        if self.window_s is not None:
            raise ExprError(
                f"range selector {self.name}[...] needs a function "
                f"(rate/increase/quantile_over_time) around it"
            )
        out: Vector = []
        for s in ctx.tsdb.matching(self.name, self.match or None):
            if self.offset_s <= 0:
                pts = ctx.tsdb.points(s)
                if pts:
                    out.append((s.labels, pts[-1][1]))
                continue
            # shifted instant: the last sample at or before now-offset,
            # looked up within one default window of it
            shifted = ctx.now - self.offset_s
            pts = [
                (t, v) for t, v in ctx.tsdb.points(
                    s, ctx.default_window_s + self.offset_s, ctx.now
                ) if t <= shifted
            ]
            if pts:
                out.append((s.labels, pts[-1][1]))
        return out


def _offset_window(ctx: "_Ctx", s: Any, window_s: float,
                   offset_s: float) -> tuple[Optional[tuple[float, float]],
                                             list[tuple[float, float]]]:
    """(baseline, points) for the shifted window
    [now-offset-window, now-offset]: the in-window samples plus the
    last sample before the window (searched one extra window back) —
    the reset-aware seed `series_increase` would use."""
    shifted = ctx.now - offset_s
    cutoff = shifted - window_s
    pts = ctx.tsdb.points(s, 2.0 * window_s + offset_s, ctx.now)
    windowed = [(t, v) for t, v in pts if cutoff <= t <= shifted]
    baseline = None
    for t, v in pts:
        if t < cutoff:
            baseline = (t, v)
        else:
            break
    return baseline, windowed


class _RangeFn(_Node):
    def __init__(self, fn: str, sel: _Selector, q: Optional[float]):
        self.fn = fn
        self.sel = sel
        self.q = q

    def eval(self, ctx: "_Ctx") -> Optional[Value]:
        window = self.sel.window_s or ctx.default_window_s
        offset = self.sel.offset_s
        out: Vector = []
        for s in ctx.tsdb.matching(self.sel.name, self.sel.match or None):
            if self.fn == "quantile_over_time":
                if offset > 0:
                    _base, win = _offset_window(ctx, s, window, offset)
                    vals = [v for _t, v in win]
                else:
                    vals = [
                        v for _t, v in ctx.tsdb.points(s, window, ctx.now)
                    ]
                qv = quantile_of(vals, self.q if self.q is not None else 0.99)
                if qv is not None:
                    out.append((s.labels, qv))
                continue
            if offset > 0:
                base, win = _offset_window(ctx, s, window, offset)
                inc = increase_of(([base] if base is not None else []) + win)
            else:
                inc = ctx.tsdb.series_increase(s, window, ctx.now)
            if self.fn == "rate":
                inc = inc / window if window > 0 else 0.0
            out.append((s.labels, inc))
        return out


class _Agg(_Node):
    def __init__(self, op: str, by: tuple[str, ...], arg: _Node):
        self.op = op
        self.by = by
        self.arg = arg

    def eval(self, ctx: "_Ctx") -> Optional[Value]:
        val = self.arg.eval(ctx)
        if val is None:
            return None
        if isinstance(val, float):
            val = [((), val)]
        groups: dict[LabelPairs, list[float]] = {}
        for labels, v in val:
            ld = dict(labels)
            key: LabelPairs = tuple(
                (name, ld.get(name, "")) for name in self.by
            )
            groups.setdefault(key, []).append(v)
        out: Vector = []
        for key, vs in groups.items():
            if self.op == "sum":
                agg = sum(vs)
            elif self.op in ("mean", "avg"):
                agg = sum(vs) / len(vs)
            elif self.op == "max":
                agg = max(vs)
            elif self.op == "min":
                agg = min(vs)
            else:  # count
                agg = float(len(vs))
            out.append((key, agg))
        if not self.by:
            # bare sum(...) collapses to a scalar-like single sample
            return out[0][1] if out else []
        return out


class _BinOp(_Node):
    def __init__(self, op: str, lhs: _Node, rhs: _Node):
        self.op = op
        self.lhs = lhs
        self.rhs = rhs

    def _apply(self, a: float, b: float) -> Optional[float]:
        if self.op == "+":
            return a + b
        if self.op == "-":
            return a - b
        if self.op == "*":
            return a * b
        if b == 0:
            return None  # dropped: no-denominator reads as no-data
        return a / b

    def eval(self, ctx: "_Ctx") -> Optional[Value]:
        lv = self.lhs.eval(ctx)
        rv = self.rhs.eval(ctx)
        if lv is None or rv is None:
            return None
        if isinstance(lv, float) and isinstance(rv, float):
            return self._apply(lv, rv)
        if isinstance(lv, float):
            assert isinstance(rv, list)
            out = [
                (labels, r) for labels, v in rv
                if (r := self._apply(lv, v)) is not None
            ]
            return out
        if isinstance(rv, float):
            out = [
                (labels, r) for labels, v in lv
                if (r := self._apply(v, rv)) is not None
            ]
            return out
        # vector ∘ vector: one-to-one on the exact label set — aggregate
        # both sides with the same `by (...)` clause to line them up
        rhs_by_labels = dict(rv)
        out = []
        for labels, v in lv:
            other = rhs_by_labels.get(labels)
            if other is None:
                continue
            r = self._apply(v, other)
            if r is not None:
                out.append((labels, r))
        return out


class _Neg(_Node):
    def __init__(self, arg: _Node):
        self.arg = arg

    def eval(self, ctx: "_Ctx") -> Optional[Value]:
        val = self.arg.eval(ctx)
        if val is None:
            return None
        if isinstance(val, float):
            return -val
        return [(labels, -v) for labels, v in val]


class _Ctx:
    __slots__ = ("tsdb", "now", "default_window_s")

    def __init__(self, tsdb: TSDB, now: float, default_window_s: float):
        self.tsdb = tsdb
        self.now = now
        self.default_window_s = default_window_s


# -- parser ------------------------------------------------------------------


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.tokens = _tokenize(text)
        self.pos = 0

    def _peek(self) -> Optional[tuple[str, str]]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def _next(self) -> tuple[str, str]:
        tok = self._peek()
        if tok is None:
            raise ExprError(f"unexpected end of expression: {self.text!r}")
        self.pos += 1
        return tok

    def _expect(self, value: str) -> None:
        tok = self._next()
        if tok[1] != value:
            raise ExprError(
                f"expected {value!r}, got {tok[1]!r} in {self.text!r}"
            )

    def parse(self) -> _Node:
        node = self._additive()
        if self._peek() is not None:
            raise ExprError(
                f"trailing input after expression: {self._peek()[1]!r}"
            )
        return node

    def _additive(self) -> _Node:
        node = self._multiplicative()
        while (tok := self._peek()) is not None and tok[1] in ("+", "-"):
            self._next()
            node = _BinOp(tok[1], node, self._multiplicative())
        return node

    def _multiplicative(self) -> _Node:
        node = self._unary()
        while (tok := self._peek()) is not None and tok[1] in ("*", "/"):
            self._next()
            node = _BinOp(tok[1], node, self._unary())
        return node

    def _unary(self) -> _Node:
        tok = self._peek()
        if tok is not None and tok[1] == "-":
            self._next()
            return _Neg(self._unary())
        return self._primary()

    def _primary(self) -> _Node:
        tok = self._next()
        kind, text = tok
        if kind == "num":
            return _Number(float(text))
        if text == "(":
            node = self._additive()
            self._expect(")")
            return node
        if kind != "ident":
            raise ExprError(f"unexpected token {text!r} in {self.text!r}")
        if text in AGG_OPS:
            return self._aggregation(text)
        if text in RANGE_FNS:
            return self._range_fn(text)
        return self._selector(text)

    def _aggregation(self, op: str) -> _Node:
        by: tuple[str, ...] = ()
        tok = self._peek()
        if tok is not None and tok[1] == "by":
            self._next()
            self._expect("(")
            names: list[str] = []
            while True:
                t = self._next()
                if t[0] != "ident":
                    raise ExprError(f"bad label name {t[1]!r} in by (...)")
                names.append(t[1])
                t = self._next()
                if t[1] == ")":
                    break
                if t[1] != ",":
                    raise ExprError(
                        f"expected ',' or ')' in by (...), got {t[1]!r}"
                    )
            by = tuple(names)
        self._expect("(")
        arg = self._additive()
        self._expect(")")
        return _Agg(op, by, arg)

    def _range_fn(self, fn: str) -> _Node:
        self._expect("(")
        q: Optional[float] = None
        if fn == "quantile_over_time":
            t = self._next()
            if t[0] != "num":
                raise ExprError(
                    "quantile_over_time needs a numeric quantile first"
                )
            q = float(t[1])
            self._expect(",")
        t = self._next()
        if t[0] != "ident" or t[1] in AGG_OPS or t[1] in RANGE_FNS:
            raise ExprError(
                f"{fn}() takes a range selector like name{{...}}[5m], "
                f"got {t[1]!r}"
            )
        sel = self._selector(t[1])
        self._expect(")")
        return _RangeFn(fn, sel, q)

    def _selector(self, name: str) -> _Selector:
        match: dict[str, str] = {}
        tok = self._peek()
        if tok is not None and tok[1] == "{":
            self._next()
            while True:
                t = self._next()
                if t[1] == "}":
                    break
                if t[0] != "ident":
                    raise ExprError(
                        f"bad label matcher near {t[1]!r} in {name}{{...}}"
                    )
                label = t[1]
                self._expect("=")
                vt = self._next()
                if vt[0] != "str":
                    raise ExprError(
                        f'label {label!r} needs a quoted value '
                        f'({label}="...")'
                    )
                raw = vt[1][1:-1]
                match[label] = re.sub(r"\\(.)", r"\1", raw)
                t = self._peek()
                if t is not None and t[1] == ",":
                    self._next()
        window_s: Optional[float] = None
        tok = self._peek()
        if tok is not None and tok[1] == "[":
            self._next()
            parts: list[str] = []
            while (t := self._next())[1] != "]":
                parts.append(t[1])
            window_s = _parse_duration("".join(parts))
        offset_s = 0.0
        tok = self._peek()
        if tok is not None and tok == ("ident", "offset"):
            self._next()
            t = self._next()
            if t[0] != "num":
                raise ExprError(
                    f"offset needs a duration (e.g. offset 1h), got "
                    f"{t[1]!r}"
                )
            dur = t[1]
            unit = self._peek()
            if unit is not None and unit[0] == "ident" \
                    and unit[1] in _DURATION_UNITS:
                self._next()
                dur += unit[1]
            offset_s = _parse_duration(dur)
            if offset_s < 0:
                raise ExprError("offset must be >= 0")
        return _Selector(name, match, window_s, offset_s)


def _parse_duration(text: str) -> float:
    m = _DURATION_RE.match(text.strip())
    if m is None:
        raise ExprError(f"bad duration {text!r} (want e.g. 300s, 5m, 1h)")
    return float(m.group(1)) * _DURATION_UNITS[m.group(2)]


@functools.lru_cache(maxsize=256)
def parse(text: str) -> _Node:
    """Parse an expression to its AST (cached — rules re-evaluate the
    same text every sampler tick). Raises :class:`ExprError`."""
    if not text or not text.strip():
        raise ExprError("empty expression")
    return _Parser(text.strip()).parse()


def evaluate(tsdb: TSDB, text: str, now: Optional[float] = None,
             default_window_s: float = DEFAULT_WINDOW_S) -> Optional[Value]:
    """Evaluate `text` against `tsdb` at `now`. Returns a scalar float,
    a vector ``[(label_pairs, value), ...]``, or None (no data)."""
    node = parse(text)
    ctx = _Ctx(tsdb, time.time() if now is None else now,
               default_window_s)
    return node.eval(ctx)


def evaluate_rows(tsdb: TSDB, text: str, now: Optional[float] = None,
                  default_window_s: float = DEFAULT_WINDOW_S
                  ) -> list[dict[str, Any]]:
    """JSON-able evaluation: ``[{"labels": {...}, "value": v}, ...]``
    (a scalar result is one row with empty labels). This is the shape
    `GET /debug/tsdb?expr=`, `pio tsdb query` and the dashboard render."""
    val = evaluate(tsdb, text, now, default_window_s)
    if val is None:
        return []
    if isinstance(val, float):
        return [{"labels": {}, "value": val}]
    rows = [
        {"labels": dict(labels), "value": v} for labels, v in val
    ]
    rows.sort(key=lambda r: sorted(r["labels"].items()))
    return rows
