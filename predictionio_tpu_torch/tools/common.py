"""Operator commands shared by the console's app, channel and access-key
verbs.

Counterpart of the JAX package's ``tools/common.py`` (reference
admin/CommandClient.scala:58): an app is created with its default access
key, and deleted with its channels, events and keys.
"""

from __future__ import annotations

import secrets
from typing import Optional

from predictionio_tpu_torch.data.storage.base import AccessKey, App
from predictionio_tpu_torch.data.storage.registry import Storage


class CommandError(ValueError):
    pass


def create_app(
    storage: Storage,
    name: str,
    description: Optional[str] = None,
    access_key: Optional[str] = None,
    app_id: int = 0,
) -> tuple[App, str]:
    """Create the app (with `app_id` when it is positive, else the next
    id), its default event namespace and its default access key
    (`access_key`, else a generated one); returns (app, key). A key that
    is taken rolls the app back."""
    apps = storage.get_meta_data_apps()
    if apps.get_by_name(name) is not None:
        raise CommandError(f"App {name!r} already exists.")
    new_id = apps.insert(App(id=app_id, name=name, description=description))
    if new_id is None:
        raise CommandError(f"App id {app_id} is already taken.")
    storage.get_events().init_app(new_id)
    key = access_key or secrets.token_urlsafe(32)
    if storage.get_meta_data_access_keys().insert(
            AccessKey(key=key, app_id=new_id, events=())) is None:
        storage.get_events().remove_app(new_id)
        apps.delete(new_id)
        raise CommandError(f"Access key {key!r} already exists.")
    return App(id=new_id, name=name, description=description), key


def create_access_key(storage: Storage, app: App, key: Optional[str],
                      events: tuple[str, ...]) -> str:
    created = storage.get_meta_data_access_keys().insert(
        AccessKey(key=key or secrets.token_urlsafe(32), app_id=app.id, events=events))
    if created is None:
        raise CommandError(f"Access key {key!r} already exists.")
    return created


def resolve_channel(storage: Storage, app: App, name: str) -> int:
    """The id of the app's channel of that name."""
    match = [c for c in storage.get_meta_data_channels().get_by_app_id(app.id)
             if c.name == name]
    if not match:
        raise CommandError(f"Channel {name!r} does not exist.")
    return match[0].id


def delete_app(storage: Storage, app: App) -> None:
    """The app's channels with their events, its default events, its
    keys, then its row."""
    events, channels = storage.get_events(), storage.get_meta_data_channels()
    for ch in channels.get_by_app_id(app.id):
        events.remove_app(app.id, ch.id)
        channels.delete(ch.id)
    events.remove_app(app.id)
    keys = storage.get_meta_data_access_keys()
    for k in keys.get_by_app_id(app.id):
        keys.delete(k.key)
    storage.get_meta_data_apps().delete(app.id)


def delete_app_data(storage: Storage, app: App, channel_id: Optional[int] = None,
                    all_channels: bool = False) -> None:
    """Empty one channel's events, the default channel's, or (with
    `all_channels`) every channel's and the default's."""
    events = storage.get_events()
    if all_channels:
        for ch in storage.get_meta_data_channels().get_by_app_id(app.id):
            events.remove_app(app.id, ch.id)
            events.init_app(app.id, ch.id)
        channel_id = None
    events.remove_app(app.id, channel_id)
    events.init_app(app.id, channel_id)
