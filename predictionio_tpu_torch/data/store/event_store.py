"""App-name-based event store facade for engine code.

Counterpart of the JAX package's ``data/store/event_store.py``
(reference PEventStore.scala:32, LEventStore.scala:30): ``find_frame``
for training reads, in the app's default channel or the one named by
``channel_name``, and ``find_by_entities`` for serving-time history
reads in the default channel, over a `Storage`. ``find_frame`` takes
the store's columnar read where it has one (sqlite), else packs the
store's ``find``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from predictionio_tpu_torch.data.storage.base import EventQuery, StorageError
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.data.store.columnar import EventFrame


class EventStoreFacade:
    def __init__(self, storage: Storage):
        self.storage = storage

    def app_name_to_id(
        self, app_name: str, channel_name: Optional[str] = None
    ) -> tuple[int, Optional[int]]:
        """(app id, channel id) of the names (reference
        store/Common.scala:28); the channel id is None for the default
        channel."""
        app = self.storage.get_meta_data_apps().get_by_name(app_name)
        if app is None:
            raise StorageError(f"Invalid app name {app_name!r}")
        if channel_name is None:
            return app.id, None
        match = [c for c in self.storage.get_meta_data_channels().get_by_app_id(app.id)
                 if c.name == channel_name]
        if not match:
            raise StorageError(
                f"Invalid channel name {channel_name!r} for app {app_name!r}")
        return app.id, match[0].id

    def find_frame(
        self,
        app_name: str,
        channel_name: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        entity_type: Optional[str] = None,
        target_entity_type: Optional[str] = None,
        value_prop: Optional[str] = None,
        default_value: float = 1.0,
    ) -> EventFrame:
        """The app's events as columns, in (event_time, event_id) order
        (reference PEventStore.find), with `value_prop` as the value
        column (`default_value` where it is missing)."""
        app_id, channel_id = self.app_name_to_id(app_name, channel_name)
        query = EventQuery(
            app_id=app_id, channel_id=channel_id, entity_type=entity_type,
            event_names=event_names, target_entity_type=target_entity_type,
        )
        store = self.storage.get_events()
        fast = getattr(store, "find_frame", None)
        if fast is not None:
            return fast(query, value_prop=value_prop, default_value=default_value)
        return EventFrame.from_events(
            store.find(query), value_prop=value_prop, default_value=default_value
        )

    def find_by_entities(
        self,
        app_name: str,
        entity_type: str,
        entity_ids,
        event_names: Optional[Sequence[str]] = None,
        limit_per_entity: Optional[int] = None,
    ) -> dict:
        """{entity_id: [events]}, newest first, in one store call — the
        serving micro-batch's history read."""
        app_id, _ = self.app_name_to_id(app_name)
        return self.storage.get_events().find_entities_batch(
            app_id, entity_type, entity_ids,
            event_names=event_names, limit_per_entity=limit_per_entity,
        )
