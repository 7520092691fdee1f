"""Operator shell with the port preloaded.

Counterpart of the JAX package's ``tools/shell.py`` (the reference's
bin/pio-shell:16-30, a spark-shell with the pio assembly on the
classpath): a Python REPL with the port's storage registry, its event
store and ``EventStoreFacade``, the query types and the model and engine
packages already imported, connected by the same ``PIO_STORAGE_*``
environment the servers read.

    $ python -m predictionio_tpu_torch.tools.shell
    pio> storage.verify_all_data_objects()
    pio> list(events.find(EventQuery(app_id=1, limit=5)))
    pio> help_pio()

``python -m predictionio_tpu_torch.tools.shell script.py [args...]``
runs a script in that namespace, and piped input runs as a script.
Nothing is imported of the device until a model or engine module is.
"""

from __future__ import annotations

import code
import sys


def make_namespace() -> dict:
    """Build the preloaded namespace (importable for tests)."""
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.base import EventQuery
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.data.store.event_store import EventStoreFacade

    storage = Storage.get_instance()

    def help_pio():
        print(
            "Preloaded:\n"
            "  storage     — storage registry (verify_all_data_objects(),\n"
            "                get_events(), get_meta_data_apps(), ...)\n"
            "  events      — the EVENTDATA event store\n"
            "  facade      — EventStoreFacade (app-name reads: find,\n"
            "                aggregate_properties)\n"
            "  Event, EventQuery — the event model\n"
            "  models, engines   — lazy import roots, e.g.\n"
            "                from predictionio_tpu_torch.models import als\n"
        )

    import predictionio_tpu_torch.engines as engines
    import predictionio_tpu_torch.models as models

    return {
        "storage": storage,
        "events": storage.get_events(),
        "facade": EventStoreFacade(storage),
        "Event": Event,
        "EventQuery": EventQuery,
        "models": models,
        "engines": engines,
        "help_pio": help_pio,
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ns = make_namespace()
    banner = (
        "predictionio_tpu_torch shell — framework preloaded "
        "(type help_pio() for the tour)"
    )
    if argv:
        # spark-shell-style `pio-shell script.py [args...]`: run the
        # script in the preloaded namespace
        path = argv[0]
        ns["__name__"] = "__main__"
        sys.argv = argv
        with open(path) as f:
            exec(compile(f.read(), path, "exec"), ns)
        return 0
    if not sys.stdin.isatty():
        # piped input (smoke tests, scripting): execute it in the
        # preloaded namespace instead of an interactive prompt
        src = sys.stdin.read()
        exec(compile(src, "<pio-shell>", "exec"), ns)
        return 0
    try:
        import readline  # noqa: F401  (line editing when available)
    except ImportError:
        pass
    code.interact(banner=banner, local=ns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
