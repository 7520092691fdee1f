"""Event-server plugins: input blockers and input sniffers.

Counterpart of the JAX package's ``data/api/plugins.py`` (reference
data/.../api/EventServerPlugin.scala:18-30). An ``inputblocker`` runs
before the event is stored and rejects it by raising; an
``inputsniffer`` observes it after the store, and its failures never
reach the client. A plugin is any object with a ``plugin_type`` (one
of the two below) and a ``process(event_json, context)``; plugins are
passed to the server as a list.
"""

from __future__ import annotations

import logging

log = logging.getLogger(__name__)

INPUT_BLOCKER = "inputblocker"
INPUT_SNIFFER = "inputsniffer"


class PluginContext:
    def __init__(self, plugins=()):
        self.blockers = [p for p in plugins
                         if getattr(p, "plugin_type", "") == INPUT_BLOCKER]
        self.sniffers = [p for p in plugins
                         if getattr(p, "plugin_type", "") == INPUT_SNIFFER]

    def run_blockers(self, event_json: dict, context: dict) -> None:
        """Any raise rejects the event (reference EventServer.scala:273-277)."""
        for p in self.blockers:
            p.process(event_json, context)

    def run_sniffers(self, event_json: dict, context: dict) -> None:
        """A sniffer's failure is logged, never raised."""
        for p in self.sniffers:
            try:
                p.process(event_json, context)
            except Exception:
                log.exception("input sniffer %s failed", getattr(p, "plugin_name", p))
