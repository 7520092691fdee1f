"""App-name-based event store facade for engine code.

Counterpart of the JAX package's ``data/store/event_store.py``
(reference PEventStore.scala:32, LEventStore.scala:30), over a
`Storage`: ``find_frame`` and ``aggregate_properties`` for training
reads, in the app's default channel or the one named by
``channel_name``; ``find_by_entity`` and ``find_by_entities`` for
serving-time reads, newest first. ``find_frame`` takes the store's
columnar read where it has one (sqlite), else packs the store's
``find``. ``PEventStore`` and ``LEventStore`` name the same facade, as
in the JAX package.
"""

from __future__ import annotations

import datetime as _dt
from typing import Iterator, Optional, Sequence

from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event

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
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        value_prop: Optional[str] = None,
        default_value: float = 1.0,
    ) -> EventFrame:
        """The app's events in [start_time, until_time) as columns, in
        (event_time, event_id) order (reference PEventStore.find), with
        `value_prop` as the value column (`default_value` where it is
        missing)."""
        app_id, channel_id = self.app_name_to_id(app_name, channel_name)
        query = EventQuery(
            app_id=app_id, channel_id=channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            event_names=event_names, target_entity_type=target_entity_type,
        )
        store = self.storage.get_events()
        fast = getattr(store, "find_frame", None)
        if fast is not None:
            return fast(query, value_prop=value_prop, default_value=default_value)
        return EventFrame.from_events(
            store.find(query), value_prop=value_prop, default_value=default_value
        )

    def aggregate_properties(
        self,
        app_name: str,
        entity_type: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[Sequence[str]] = None,
    ) -> dict[str, PropertyMap]:
        """entity_id → PropertyMap of the type's $set/$unset/$delete
        events (reference PEventStore.aggregateProperties)."""
        app_id, channel_id = self.app_name_to_id(app_name, channel_name)
        return self.storage.get_events().aggregate_properties(
            app_id, entity_type, channel_id=channel_id, start_time=start_time,
            until_time=until_time, required=required,
        )

    def find_by_entity(
        self,
        app_name: str,
        entity_type: str,
        entity_id: str,
        channel_name: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        limit: Optional[int] = None,
        latest: bool = True,
        timeout: float = 10.0,
    ) -> Iterator[Event]:
        """One entity's events, newest first unless `latest` is false
        (reference LEventStore.findByEntity:58). `timeout` is kept for
        the JAX package's signature; the ported stores read in process."""
        app_id, channel_id = self.app_name_to_id(app_name, channel_name)
        return self.storage.get_events().find_single_entity(
            app_id, entity_type, entity_id, channel_id=channel_id,
            event_names=event_names, target_entity_type=target_entity_type,
            target_entity_id=target_entity_id, start_time=start_time,
            until_time=until_time, limit=limit, reversed=latest,
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


# the reference's two objects, one facade here as in the JAX package
PEventStore = EventStoreFacade
LEventStore = EventStoreFacade
