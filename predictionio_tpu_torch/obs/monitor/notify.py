"""Alert notification sinks.

Counterpart of the JAX package's ``obs/monitor/notify.py``, the port's
own copy. ``GET /alerts`` is pull-only; on a pending → firing transition
(and on resolve) the notifier pushes the alert out through two optional
sinks:

  PIO_ALERT_WEBHOOK   POST the alert JSON to this URL
  PIO_ALERT_EXEC      run this command; the alert JSON arrives on stdin
                      and in $PIO_ALERT_JSON (argv split without a shell)

Delivery is best-effort and off the evaluation path: each notification
runs on a short-lived daemon thread, bounded by a semaphore so that a
hung webhook cannot pile threads up behind it, and outcomes land in
``alert_notifications_total{sink,outcome}``. The JAX package marks both
deliveries as blocking points for its thread sanitizer; the port has no
sanitizer (``analysis/`` is not ported), so those two hooks are left out.
"""

from __future__ import annotations

import json
import logging
import os
import shlex
import threading
from typing import Any, Optional

from predictionio_tpu_torch.utils.env import monitor_knob

log = logging.getLogger(__name__)

MAX_INFLIGHT = 4
TIMEOUT_S = 10.0


class AlertNotifier:
    def __init__(
        self,
        webhook_url: Optional[str] = None,
        exec_cmd: Optional[str] = None,
        registry=None,
    ):
        self.webhook_url = webhook_url
        self.exec_cmd = exec_cmd
        self._inflight = threading.Semaphore(MAX_INFLIGHT)
        # in-flight delivery threads, so that close() can join them: no
        # delivery outlives the SLO engine that pushed its alert
        self._threads_lock = threading.Lock()
        self._threads: set[threading.Thread] = set()  # guarded by _threads_lock
        if registry is None:
            from predictionio_tpu_torch.obs.registry import get_default_registry

            registry = get_default_registry()
        self._counter = registry.counter(
            "alert_notifications_total",
            "alert notifications pushed, by sink and outcome",
            ("sink", "outcome"),  # label-bound: literal sink/outcome sets
        )

    @staticmethod
    def from_env(env: Optional[dict] = None) -> "AlertNotifier":
        return AlertNotifier(
            webhook_url=monitor_knob("PIO_ALERT_WEBHOOK", env).strip() or None,
            exec_cmd=monitor_knob("PIO_ALERT_EXEC", env).strip() or None,
        )

    def active(self) -> bool:
        return bool(self.webhook_url or self.exec_cmd)

    # -- dispatch -----------------------------------------------------------
    def notify(self, alert: dict[str, Any]) -> None:
        """Fire-and-forget push of one alert transition. Dropped (and
        counted) when MAX_INFLIGHT notifications are already in flight —
        a wedged sink must not back up the SLO engine."""
        if not self.active():
            return
        if not self._inflight.acquire(blocking=False):
            self._counter.inc(sink="(any)", outcome="dropped_inflight")
            return
        t = threading.Thread(
            target=self._deliver, args=(dict(alert),),
            name="alert-notify", daemon=True,
        )
        with self._threads_lock:
            self._threads.add(t)
        t.start()

    def _deliver(self, alert: dict[str, Any]) -> None:
        try:
            payload = json.dumps(alert, default=str)
            if self.webhook_url:
                self._post(payload)
            if self.exec_cmd:
                self._exec(payload)
        finally:
            self._inflight.release()
            with self._threads_lock:
                self._threads.discard(threading.current_thread())

    def close(self, timeout: float = TIMEOUT_S) -> None:
        """Join in-flight deliveries — the owner (Monitor/SLO engine)
        calls this on stop so no notification thread outlives it."""
        with self._threads_lock:
            pending = list(self._threads)
        for t in pending:
            t.join(timeout=timeout)
        with self._threads_lock:
            self._threads.difference_update(
                t for t in pending if not t.is_alive()
            )

    def _post(self, payload: str) -> None:
        import urllib.request

        try:
            req = urllib.request.Request(
                self.webhook_url,
                data=payload.encode(),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=TIMEOUT_S):
                pass
            self._counter.inc(sink="webhook", outcome="ok")
        except Exception as e:
            self._counter.inc(sink="webhook", outcome="error")
            log.warning("alert webhook delivery failed: %s", e)

    def _exec(self, payload: str) -> None:
        import subprocess

        try:
            argv = shlex.split(self.exec_cmd)
            proc = subprocess.run(
                argv,
                input=payload.encode(),
                env=dict(os.environ, PIO_ALERT_JSON=payload),
                timeout=TIMEOUT_S,
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
                check=False,
            )
            if proc.returncode == 0:
                self._counter.inc(sink="exec", outcome="ok")
            else:
                # a pager script exiting nonzero means the page did NOT
                # go out — the delivery metric must say so
                self._counter.inc(sink="exec", outcome="error")
                log.warning(
                    "alert exec sink exited %d", proc.returncode
                )
        except Exception as e:
            self._counter.inc(sink="exec", outcome="error")
            log.warning("alert exec sink failed: %s", e)
