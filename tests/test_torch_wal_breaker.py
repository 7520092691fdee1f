"""The port's retry policy, circuit breaker and event write-ahead log on
the CPU, against the JAX package's.

- ``resilience/breaker.py``: both packages' breakers, each under its own
  fake clock, driven by one script of allow / success / failure /
  release / clock steps, give the same verdicts, states, state gauges and
  transition counts at every step (closed → open → half-open with one
  probe, a failed probe, the released probe, the streak reset);
  ``get_breaker`` and ``reset_breakers``.
- ``resilience/retry.py``: the backoff schedule with and without jitter
  (one seeded ``random.Random`` each) equal draw for draw; ``call``'s
  attempts, ``on_retry`` reports, re-raise and deadline stop equal.
- ``resilience/wal.py``: segments written by either package replay in
  the other, in arrival order, with the req_ids and namespaces kept;
  a replay that dies mid-segment resumes in the other package from the
  acks with nothing sent twice; the batched replay's chunks and batch
  ids equal; appends racing a replay are kept; segment names and
  records have the JAX layout.
"""

import json
import os
import random
import time

import pytest

pytest.importorskip("jax")

from predictionio_tpu.data.event import Event as JEvent  # noqa: E402
from predictionio_tpu.obs.registry import MetricsRegistry as JRegistry  # noqa: E402
from predictionio_tpu.resilience import breaker as jbreaker  # noqa: E402
from predictionio_tpu.resilience.retry import RetryPolicy as JRetry  # noqa: E402
from predictionio_tpu.resilience.wal import EventWAL as JWAL  # noqa: E402
from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.obs.registry import MetricsRegistry  # noqa: E402
from predictionio_tpu_torch.resilience import breaker  # noqa: E402
from predictionio_tpu_torch.resilience.retry import RetryPolicy  # noqa: E402
from predictionio_tpu_torch.resilience.wal import EventWAL  # noqa: E402


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# the circuit breaker
# ---------------------------------------------------------------------------

BREAKER_SCRIPT = [
    "allow", "fail", "allow", "fail", "state", "allow", "succeed",  # the streak resets
    "fail", "fail", "fail", "state", "allow",  # threshold 3: open, fail fast
    ("tick", 4.0), "allow", "state", ("tick", 1.5), "state",  # cooldown 5: half-open
    "allow", "allow", "fail", "state", "allow",  # one probe; it fails: open again
    ("tick", 5.0), "allow", "release", "allow", "allow",  # a released probe slot
    "succeed", "state", "allow", "fail", "state",  # closed; one failure is no trip
]


def _play_breaker(module, registry_cls):
    clock, reg = FakeClock(), registry_cls()
    b = module.CircuitBreaker("ep", failure_threshold=3, cooldown_s=5.0, registry=reg,
                              clock=clock, dao="events")
    gauge = reg.gauge("resilience_breaker_state", "", ("endpoint", "dao"))
    trans = reg.counter("resilience_breaker_transitions_total", "",
                        ("endpoint", "dao", "state"))
    out = []
    for step in BREAKER_SCRIPT:
        if isinstance(step, tuple):
            clock.t += step[1]
            got = None
        elif step == "allow":
            got = b.allow()
        elif step == "fail":
            got = b.record_failure()
        elif step == "succeed":
            got = b.record_success()
        elif step == "release":
            got = b.release_probe()
        else:
            got = b.state
        out.append((step, got, gauge.value(endpoint="ep", dao="events"),
                    tuple(trans.value(endpoint="ep", dao="events", state=s)
                          for s in ("open", "half_open", "closed"))))
    return out


def test_breaker_script_equals_jax():
    got = _play_breaker(breaker, MetricsRegistry)
    want = _play_breaker(jbreaker, JRegistry)
    assert got == want
    states = [g for step, g, *_ in got if step == "state"]
    assert states == ["closed", "open", "open", "half_open", "open", "closed", "closed"]
    assert got[-1][3] == (2, 2, 1)  # opened twice, probed twice, closed once


def test_breaker_call_wrapper_and_registry():
    for module, reg_cls in ((breaker, MetricsRegistry), (jbreaker, JRegistry)):
        module.reset_breakers()
        clock = FakeClock()
        b = module.CircuitBreaker("w", failure_threshold=1, cooldown_s=1.0,
                                  registry=reg_cls(), clock=clock)
        assert b.call(lambda x: x + 1, 1) == 2
        with pytest.raises(ZeroDivisionError):
            b.call(lambda: 1 / 0)
        with pytest.raises(module.CircuitOpenError, match="circuit breaker w is open"):
            b.call(lambda: 0)
        one = module.get_breaker("shared", failure_threshold=2, registry=reg_cls())
        assert module.get_breaker("shared", failure_threshold=9) is one
        assert one.failure_threshold == 2  # kwargs configure the first one only
        module.reset_breakers()
        assert module.get_breaker("shared", registry=reg_cls()) is not one
        module.reset_breakers()


# ---------------------------------------------------------------------------
# the retry policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jitter", [0.0, 0.5, 1.0])
def test_backoff_schedule_equals_jax(jitter):
    kw = dict(max_attempts=8, base_delay=0.1, multiplier=2.0, max_delay=0.5, jitter=jitter)
    got = RetryPolicy(rng=random.Random(42), **kw)
    want = JRetry(rng=random.Random(42), **kw)
    delays = [got.delay(i) for i in range(12)]
    assert delays == [want.delay(i) for i in range(12)]
    if not jitter:
        assert delays[:4] == [0.1, 0.2, 0.4, 0.5]


def _retry_trace(policy, fails, exc, deadline=None):
    calls, retried = [], []

    def fn(attempt):
        calls.append(attempt)
        if attempt < fails:
            raise exc(f"down {attempt}")
        return "ok"

    try:
        out = policy.call(fn, retry_on=(OSError,), deadline=deadline,
                          on_retry=lambda i, e: retried.append((i, str(e))))
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        out = (type(e).__name__, str(e))
    return out, calls, retried


@pytest.mark.parametrize("fails, exc", [(0, OSError), (2, OSError), (5, OSError),
                                        (1, ValueError)])
def test_retry_call_equals_jax(fails, exc):
    kw = dict(max_attempts=4, base_delay=0.001, jitter=0.0)
    got = _retry_trace(RetryPolicy(**kw), fails, exc)
    assert got == _retry_trace(JRetry(**kw), fails, exc)
    if exc is ValueError:
        assert got[1] == [0]  # not retried
    elif fails >= 4:
        assert got[0] == ("OSError", "down 3") and got[1] == [0, 1, 2, 3]


def test_retry_stops_at_the_deadline_as_jax():
    kw = dict(max_attempts=10, base_delay=0.2, multiplier=1.0, jitter=0.0)
    for policy in (RetryPolicy(**kw), JRetry(**kw)):
        t0 = time.monotonic()
        out, calls, _ = _retry_trace(policy, 99, OSError, deadline=time.monotonic() + 0.3)
        assert out[0] == "OSError" and len(calls) <= 3
        assert time.monotonic() - t0 < 1.0
    for policy in (RetryPolicy(**kw), JRetry(**kw)):
        _, calls, _ = _retry_trace(policy, 99, OSError, deadline=time.monotonic() - 1)
        assert calls == [0]  # an expired budget: one attempt, no sleep


# ---------------------------------------------------------------------------
# the write-ahead log
# ---------------------------------------------------------------------------

PACKAGES = {"port": (EventWAL, Event), "jax": (JWAL, JEvent)}


def _event(event_cls, i):
    return event_cls(event="buy", entity_type="user", entity_id=f"u{i}",
                     properties={"i": i})


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port")])
def test_segments_replay_across_packages(tmp_path, writer, reader):
    wal_cls, event_cls = PACKAGES[writer]
    w = wal_cls(str(tmp_path))
    ids = [w.append(_event(event_cls, i), 1 + i % 2, 7 if i == 3 else None)
           for i in range(6)]
    w.close()
    [seg] = os.listdir(tmp_path)
    assert seg.startswith("wal-") and seg.endswith(f"-000001-{os.getpid()}.jsonl")
    with open(tmp_path / seg) as f:
        recs = [json.loads(line) for line in f]
    assert [sorted(r) for r in recs] == [["app_id", "channel_id", "event", "req_id", "ts"]] * 6
    assert [r["event"]["eventId"] for r in recs] == ids  # the req_id stamps the id
    r = PACKAGES[reader][0](str(tmp_path))
    assert r.pending() == 6
    landed = []
    n, err = r.replay(lambda e, a, c, q: landed.append((e.entity_id, e.event_id, a, c, q)))
    assert (n, err) == (6, None) and r.pending() == 0
    assert landed == [(f"u{i}", ids[i], 1 + i % 2, 7 if i == 3 else None, ids[i])
                      for i in range(6)]
    assert os.listdir(tmp_path) == []  # the acked segment is reclaimed


@pytest.mark.parametrize("first, second", [("port", "jax"), ("jax", "port")])
def test_crash_mid_replay_resumes_in_the_other_package(tmp_path, first, second):
    wal_cls, event_cls = PACKAGES[first]
    w = wal_cls(str(tmp_path))
    for i in range(7):
        w.append(_event(event_cls, i), 2, None)
    landed = []

    def dies_after_three(e, a, c, q):
        if len(landed) == 3:
            raise OSError("storage died again")
        landed.append(q)

    n, err = w.replay(dies_after_three)
    assert n == 3 and isinstance(err, OSError) and w.pending() == 4
    w.close()
    # a later "process" of the other package over the same directory
    r = PACKAGES[second][0](str(tmp_path))
    assert r.pending() == 4
    n, err = r.replay(lambda e, a, c, q: landed.append(q))
    assert (n, err) == (4, None)
    assert len(landed) == len(set(landed)) == 7  # each record exactly once
    assert os.listdir(tmp_path) == []


def _batched(wal_cls, event_cls, path, fail_at=None):
    w = wal_cls(str(path))
    namespaces = [(1, None)] * 5 + [(1, 3)] * 2 + [(2, None)] * 4
    for i, (a, c) in enumerate(namespaces):
        w.append(_event(event_cls, i), a, c)
    calls = []

    def insert_batch(events, a, c, batch_req):
        if fail_at is not None and len(calls) == fail_at:
            raise OSError("down")
        calls.append(([e.entity_id for e in events], a, c, batch_req[:5]))

    n, err = w.replay_batched(insert_batch, max_batch=3)
    return n, err is not None, calls, w.pending()


@pytest.mark.parametrize("fail_at", [None, 2])
def test_batched_replay_equals_jax(tmp_path, fail_at):
    got = _batched(EventWAL, Event, tmp_path / "port", fail_at)
    want = _batched(JWAL, JEvent, tmp_path / "jax", fail_at)
    assert got == want
    if fail_at is None:
        assert [c[0] for c in got[2]] == [["u0", "u1", "u2"], ["u3", "u4"], ["u5", "u6"],
                                          ["u7", "u8", "u9"], ["u10"]]
        assert got[0] == 11 and got[3] == 0
    else:
        assert got[0] == 5 and got[3] == 6  # stopped at the stuck chunk


def test_batch_ids_follow_the_ack_state_across_packages(tmp_path):
    """A batch's req_id is `walb-` + its first member's: the other package,
    resuming after the chunk's acks were lost, sends the same id again
    (the daemon then replays its recorded outcome)."""
    w = EventWAL(str(tmp_path))
    ids = [w.append(_event(Event, i), 1, None) for i in range(4)]
    sent = []
    w.replay_batched(lambda ev, a, c, b: sent.append(b), max_batch=2)
    assert sent == [f"walb-{ids[0]}", f"walb-{ids[2]}"]
    w2 = JWAL(str(tmp_path / "again"))
    ids2 = [w2.append(_event(JEvent, i), 1, None) for i in range(4)]
    w2.close()
    again = tmp_path / "again"
    [seg] = [n for n in os.listdir(again) if n.endswith(".jsonl")]
    with open(again / (seg + ".ack"), "w"):
        pass  # the acks of the first chunk were torn away: none on disk
    resent = []
    EventWAL(str(again)).replay_batched(lambda ev, a, c, b: resent.append(b), max_batch=2)
    assert resent == [f"walb-{ids2[0]}", f"walb-{ids2[2]}"]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_appends_during_replay_are_kept(tmp_path, package):
    wal_cls, event_cls = PACKAGES[package]
    w = wal_cls(str(tmp_path))
    w.append(_event(event_cls, 0), 1, None)
    landed = []

    def insert(e, a, c, q):
        landed.append(e.entity_id)
        if e.entity_id == "u0":
            w.append(_event(event_cls, 99), 1, None)  # a spill while draining

    w.replay(insert)
    w.replay(insert)
    assert landed == ["u0", "u99"] and w.pending() == 0


def test_segments_of_two_processes_replay_in_arrival_order(tmp_path):
    """The epoch-ms prefix orders segments across restarts: the JAX
    package's older segment replays before the port's newer one."""
    old = JWAL(str(tmp_path))
    old.append(_event(JEvent, 1), 1, None)
    old.close()
    time.sleep(0.01)
    new = EventWAL(str(tmp_path))
    new.append(_event(Event, 2), 1, None)
    assert new.pending() == 2
    landed = []
    assert new.replay(lambda e, a, c, q: landed.append(e.entity_id)) == (2, None)
    assert landed == ["u1", "u2"]


def test_torn_tail_is_skipped(tmp_path):
    w = EventWAL(str(tmp_path))
    w.append(_event(Event, 0), 1, None)
    w.close()
    [seg] = os.listdir(tmp_path)
    with open(tmp_path / seg, "a") as f:
        f.write('{"req_id": "torn", "app_')  # a crash mid-append
    for wal_cls in (EventWAL, JWAL):
        assert wal_cls(str(tmp_path)).pending() == 1


def test_batch_spill_is_one_fsync_and_replays_in_jax(tmp_path, monkeypatch):
    """The port spills a batch under one fsync (the JAX package fsyncs
    each event); the records are the JAX layout, replayed by the JAX WAL
    in order with their req_ids as the event ids."""
    import predictionio_tpu_torch.resilience.wal as wal_mod

    synced = []
    real = os.fsync
    monkeypatch.setattr(wal_mod.os, "fsync", lambda fd: (synced.append(fd), real(fd))[1])
    w = EventWAL(str(tmp_path))
    ids = w.append_batch([_event(Event, i) for i in range(5)], 3, None)
    assert len(synced) == 1 and w.pending() == 5 and len(set(ids)) == 5
    w.append(_event(Event, 5), 3, None)
    assert len(synced) == 2
    w.close()
    landed = []
    r = JWAL(str(tmp_path))
    assert r.replay(lambda e, a, c, q: landed.append((e.entity_id, e.event_id, a, q))) == (6, None)
    ids.append(landed[-1][3])
    assert landed == [(f"u{i}", ids[i], 3, ids[i]) for i in range(6)]
