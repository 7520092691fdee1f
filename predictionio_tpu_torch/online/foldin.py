"""Fold-in: a tick's events → an incremental update of the serving ALS
model.

Counterpart of the JAX package's ``online/foldin.py``. Every dirty
user's FULL history is re-read (one ``find_edges`` read for the tick's
users, one for its new items, where the JAX package reads entity by
entity) and the user's factor row re-solved against the fixed item
factors
(``models/als.py:fold_in_rows``, on the model's device); new items get
rows appended and solved the same way against the updated user
factors. A re-solve from the full history is idempotent, so replaying a
tick after a crash computes the same rows: that is what lets the
consumer's cursor give exactly-once accounting without a two-phase
commit.

Vocabularies get new ids in first-seen order, as the JAX package
assigns them, so both packages give a new id the same row. Factor
matrices grow in `grow_chunk`-row chunks. The published model is a new
object; its staged serving state is the predecessor's with the dirty
rows written (``ALSModel.adopt_serving``), so no factor matrix is
restaged. The ``online.fold`` fault point fires after each row solve:
``error`` fails the tick (the consumer retries it from its cursor) and
``corrupt`` scrambles the solved rows, the injected drift the drift
guard must catch. The sharded publish is not ported.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.resilience import faults as _faults

log = logging.getLogger(__name__)


@dataclass
class FoldInConfig:
    """Event → edge translation, as the recommendation DataSource reads
    events, so that folded rows match what a retrain derives."""

    entity_type: str = "user"
    target_entity_type: str = "item"
    event_names: tuple[str, ...] = ("rate", "buy")
    rate_event: str = "rate"  # carries value_prop; every other weighs 1.0
    value_prop: str = "rating"
    default_value: float = 1.0
    # new-item solves a tick: a flood of new items spreads over several
    # ticks, in the JAX package's order
    max_items_per_tick: int = 64
    # factor matrices grow in row chunks of this size
    grow_chunk: int = 256


@dataclass
class FoldStats:
    users_folded: int = 0
    items_folded: int = 0
    users_added: int = 0
    items_added: int = 0
    edges: int = 0
    # item ids still awaiting a solve once this result publishes; the
    # consumer commits it (`commit_pending`) only after a publish, so a
    # discarded result (a drift breach, a lost swap) keeps the carry
    pending_after: list = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["pending_after"] = len(self.pending_after)
        return d


def _grown(arr: np.ndarray, n_rows: int, chunk: int) -> np.ndarray:
    """A fresh array of at least `n_rows` rows (the next chunk multiple
    when it grows), old rows copied, new rows zero. Always a copy: the
    previous model's readers keep theirs untouched."""
    cap = max(n_rows, arr.shape[0])
    cap = -(-cap // chunk) * chunk if cap > arr.shape[0] else cap
    out = np.zeros((cap, arr.shape[1]), np.float32)
    out[: arr.shape[0]] = arr
    return out


class ALSFoldIn:
    """Applies dirty-entity batches to an ALS model (anything whose
    `.factors` carries user and item factors, vocabularies and params)."""

    def __init__(self, config: Optional[FoldInConfig] = None):
        self.config = config or FoldInConfig()
        # new items past max_items_per_tick, carried to later ticks in
        # order; changed only by commit_pending (after a publish). In
        # memory only: after a restart those rows stay zero (score 0,
        # never mis-ranked) until a retrain or a new event on them.
        self._pending_item_solves: list[str] = []

    @property
    def pending_items(self) -> list[str]:
        return list(self._pending_item_solves)

    def commit_pending(self, pending: list) -> None:
        """Adopt the carry of a PUBLISHED fold result."""
        self._pending_item_solves = list(pending)

    @staticmethod
    def find_model(runtime) -> tuple[Optional[int], Any]:
        """(index, model) of the runtime's first fold-capable model."""
        for i, m in enumerate(getattr(runtime, "models", ()) or ()):
            f = getattr(m, "factors", None)
            if f is not None and all(hasattr(f, a) for a in (
                    "user_factors", "item_factors", "user_vocab",
                    "item_vocab", "params")):
                return i, m
        return None, None

    # -- event → edge translation -------------------------------------------
    def _value(self, event_name: str, properties: dict) -> float:
        if event_name == self.config.rate_event:
            v = properties.get(self.config.value_prop)
            if isinstance(v, (int, float)):
                return float(v)
        return float(self.config.default_value)

    def _relevant(self, event) -> bool:
        return (
            event.event in self.config.event_names
            and event.entity_type == self.config.entity_type
            and event.target_entity_type == self.config.target_entity_type
            and event.target_entity_id is not None
        )

    def dirty_entities(self, events) -> tuple[list[str], list[str]]:
        """(user ids, item ids) the relevant events touch, first seen
        first."""
        users: dict[str, None] = {}
        items: dict[str, None] = {}
        for e in events:
            if self._relevant(e):
                users.setdefault(e.entity_id, None)
                items.setdefault(e.target_entity_id, None)
        return list(users), list(items)

    # -- the apply tick -----------------------------------------------------
    def apply(self, storage, app_id: int, channel_id: Optional[int], runtime,
              events: Sequence):
        """One fold tick: (new_runtime, new_model, FoldStats), or None when
        nothing relevant changed (the cursor still advances)."""
        # only the user side comes from the events: the item solve set
        # comes from the histories read below
        dirty_users, _ = self.dirty_entities(events)
        if not dirty_users:
            return None
        ix, model = self.find_model(runtime)
        if model is None:
            log.warning("online fold-in: no fold-capable model in the "
                        "runtime; events consumed without folding")
            return None

        from predictionio_tpu_torch.models import als

        factors = model.factors
        params = factors.params
        cfg = self.config
        store = storage.get_events()

        # each dirty user's whole history, oldest first: a state-based
        # re-solve
        user_edges: dict[str, dict[str, float]] = {}
        for uid, iid, name, props in store.find_edges(
                app_id, cfg.entity_type, cfg.target_entity_type,
                cfg.event_names, entity_ids=dirty_users,
                channel_id=channel_id):
            # repeated (user, item) pairs sum, as the train's
            # interactions(dedupe="sum") does
            agg = user_edges.setdefault(uid, {})
            agg[iid] = agg.get(iid, 0.0) + self._value(name, props)
        if not user_edges:
            return None

        stats = FoldStats()
        user_vocab = factors.user_vocab.to_dict()
        item_vocab = factors.item_vocab.to_dict()
        new_items: list[str] = []
        for uid in user_edges:
            if uid not in user_vocab:
                user_vocab[uid] = len(user_vocab)
                stats.users_added += 1
        for agg in user_edges.values():
            for iid in agg:
                if iid not in item_vocab:
                    item_vocab[iid] = len(item_vocab)
                    new_items.append(iid)
                    stats.items_added += 1

        # the item solve set: the carry first, then this tick's new
        # items; the rest carries on. A carried id missing from the vocab
        # (a retrain whose data predates it swapped in) re-enters as new:
        # its events are behind the cursor. Decided before the item
        # matrix is copied, so a pending row never lands in a published
        # array.
        for iid in self._pending_item_solves:
            if iid not in item_vocab:
                item_vocab[iid] = len(item_vocab)
                new_items.append(iid)
                stats.items_added += 1
        carried = [i for i in self._pending_item_solves if i in item_vocab]
        item_candidates = list(dict.fromkeys(carried + new_items))
        solve_items = item_candidates[: cfg.max_items_per_tick]
        uf = _grown(factors.user_factors, len(user_vocab), cfg.grow_chunk)
        items_changed = bool(new_items) or bool(solve_items)
        itf = (_grown(factors.item_factors, len(item_vocab), cfg.grow_chunk)
               if items_changed else factors.item_factors)

        # the user side, against the FIXED item factors
        rows: list[int] = []
        edge_lists: list[list[tuple[int, float]]] = []
        for uid, agg in user_edges.items():
            edges = [(item_vocab[iid], v) for iid, v in agg.items()
                     if item_vocab[iid] < itf.shape[0]]
            stats.edges += len(edges)
            rows.append(user_vocab[uid])
            edge_lists.append(edges)
        solved = als.fold_in_rows(itf, edge_lists, params, device=model.device)
        if _faults.fire("online.fold", corruptable=True) == "corrupt":
            solved = solved * 40.0 + 7.0
        uf[np.asarray(rows, np.int64)] = solved
        stats.users_folded = len(rows)

        # the item side, new items against the updated user factors
        dirty_items = None
        if solve_items:
            dirty_items = self._solve_item_rows(
                store, app_id, channel_id, solve_items, user_vocab,
                item_vocab, uf, itf, params, stats, model.device,
            )
        stats.pending_after = item_candidates[cfg.max_items_per_tick:]

        # publish vocab-sized views (the chunk padding must not reach the
        # scores); their buffers are never written again
        from predictionio_tpu_torch.data.store.bimap import BiMap

        new_factors = dataclasses.replace(
            factors,
            user_factors=uf[: len(user_vocab)],
            item_factors=itf[: len(item_vocab)],
            user_vocab=BiMap(user_vocab),
            item_vocab=BiMap(item_vocab),
        )
        new_model = self._clone_model(
            model, new_factors, items_changed,
            dirty_users=(rows, solved) if rows else None,
            dirty_items=dirty_items,
        )
        models = list(runtime.models)
        models[ix] = new_model
        return dataclasses.replace(runtime, models=models), new_model, stats

    def _solve_item_rows(self, store, app_id, channel_id, solve_items,
                         user_vocab, item_vocab, uf, itf, params, stats,
                         device):
        """Solve `solve_items`' rows into `itf` (the caller's copy)
        against `uf`; returns the (rows, values) written, for the row
        publish."""
        from predictionio_tpu_torch.models import als

        cfg = self.config
        edges: dict[str, dict[int, float]] = {iid: {} for iid in solve_items}
        for uid, iid, name, props in store.find_edges(
                app_id, cfg.entity_type, cfg.target_entity_type,
                cfg.event_names, target_ids=solve_items,
                channel_id=channel_id):
            urow = user_vocab.get(uid)
            if urow is not None and urow < uf.shape[0]:
                row = edges[iid]
                row[urow] = row.get(urow, 0.0) + self._value(name, props)
        item_rows = [item_vocab[iid] for iid in solve_items]
        item_edge_lists = [list(edges[iid].items()) for iid in solve_items]
        isolved = als.fold_in_rows(uf, item_edge_lists, params, device=device)
        if _faults.fire("online.fold", corruptable=True) == "corrupt":
            isolved = isolved * 40.0 + 7.0
        itf[np.asarray(item_rows, np.int64)] = isolved
        stats.items_folded = len(item_rows)
        return item_rows, isolved

    def apply_pending(self, storage, app_id: int, channel_id: Optional[int],
                      runtime):
        """An item-only fold for an IDLE stream, draining the carry so a
        quiet tail strands no item at a zero row. Same return and commit
        contract as `apply`."""
        if not self._pending_item_solves:
            return None
        ix, model = self.find_model(runtime)
        if model is None:
            return None
        factors = model.factors
        item_vocab = factors.item_vocab.to_dict()
        # ids not in the published vocab came from a discarded tick; they
        # re-enter through apply()'s new items when their events re-fold
        solvable = [i for i in self._pending_item_solves if i in item_vocab]
        solve_items = solvable[: self.config.max_items_per_tick]
        if not solve_items:
            return None
        stats = FoldStats()
        stats.pending_after = [
            i for i in self._pending_item_solves if i not in solve_items]
        itf = factors.item_factors.copy()  # rows will be written
        dirty_items = self._solve_item_rows(
            storage.get_events(), app_id, channel_id, solve_items,
            factors.user_vocab.to_dict(), item_vocab, factors.user_factors,
            itf, factors.params, stats, model.device,
        )
        new_model = self._clone_model(
            model, dataclasses.replace(factors, item_factors=itf), True,
            users_changed=False, dirty_items=dirty_items,
        )
        models = list(runtime.models)
        models[ix] = new_model
        return dataclasses.replace(runtime, models=models), new_model, stats

    @staticmethod
    def _clone_model(model, new_factors, items_changed: bool,
                     users_changed: bool = True, dirty_users=None,
                     dirty_items=None):
        """A new model around the folded factors, on the same device with
        the same serving dtype. Its staged state is the predecessor's with
        the dirty rows published, but only when every changed side has
        its rows: a side changed without them restages lazily."""
        cats = getattr(model, "item_categories", None)
        if cats is not None and len(cats) < new_factors.item_factors.shape[0]:
            cats = list(cats) + [frozenset()] * (
                new_factors.item_factors.shape[0] - len(cats))
        new_model = type(model)(
            new_factors, item_categories=cats,
            serve_dtype=model.serve_dtype, device=model.device,
        )
        users_safe = not users_changed or dirty_users is not None
        items_safe = not items_changed or dirty_items is not None
        if users_safe and items_safe:
            new_model.adopt_serving(
                getattr(model, "_serving_state", None),
                dirty_users=dirty_users if users_changed else None,
                dirty_items=dirty_items if items_changed else None,
            )
        return new_model
