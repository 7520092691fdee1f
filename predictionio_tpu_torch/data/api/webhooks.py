"""Webhook connectors: third-party payloads as event JSON.

Counterpart of the JAX package's ``data/api/webhooks.py`` (reference
data/.../api/Webhooks.scala:37, webhooks/JsonConnector.scala:21,
FormConnector, WebhooksConnectors.scala, SegmentIOConnector.scala,
MailChimpConnector.scala and the example connectors). A connector maps
a payload to an event's JSON object; the server then stores it through
the path a posted event takes. JSON connectors: segmentio and
examplejson; form connectors: mailchimp and exampleform.
"""

from __future__ import annotations

from typing import Mapping, Protocol


class ConnectorException(ValueError):
    pass


class JsonConnector(Protocol):
    def to_event_json(self, payload: dict) -> dict: ...


class FormConnector(Protocol):
    def to_event_json_from_form(self, form: Mapping[str, str]) -> dict: ...


# ---------------------------------------------------------------------------
# Bundled connectors
# ---------------------------------------------------------------------------


class ExampleJsonConnector:
    """Reference webhooks/examplejson/ExampleJsonConnector.scala — a minimal
    documented shape used by black-box tests."""

    def to_event_json(self, payload: dict) -> dict:
        try:
            typ = payload["type"]
            if typ == "userAction":
                return {
                    "event": payload["type"],
                    "entityType": "user",
                    "entityId": str(payload["userId"]),
                    "properties": payload.get("properties", {}),
                    "eventTime": payload.get("timestamp"),
                }
            if typ == "userActionItem":
                return {
                    "event": payload["type"],
                    "entityType": "user",
                    "entityId": str(payload["userId"]),
                    "targetEntityType": "item",
                    "targetEntityId": str(payload["itemId"]),
                    "properties": payload.get("properties", {}),
                    "eventTime": payload.get("timestamp"),
                }
        except KeyError as e:
            raise ConnectorException(f"missing {e.args[0]!r} in payload")
        raise ConnectorException(f"cannot process payload type {typ!r}")


class ExampleFormConnector:
    """Reference webhooks/exampleform/ExampleFormConnector.scala."""

    def to_event_json_from_form(self, form: Mapping[str, str]) -> dict:
        try:
            typ = form["type"]
            if typ == "userAction":
                props = {
                    k: form[k]
                    for k in ("context", "anotherProperty1", "anotherProperty2")
                    if k in form
                }
                return {
                    "event": typ,
                    "entityType": "user",
                    "entityId": form["userId"],
                    "properties": props,
                    "eventTime": form.get("timestamp"),
                }
        except KeyError as e:
            raise ConnectorException(f"missing {e.args[0]!r} in form data")
        raise ConnectorException(f"cannot process form type {typ!r}")


class SegmentIOConnector:
    """segment.com spec → events (reference SegmentIOConnector.scala:184 —
    identify/track/page/screen/alias/group)."""

    SUPPORTED = ("identify", "track", "page", "screen", "alias", "group")

    def to_event_json(self, payload: dict) -> dict:
        typ = payload.get("type")
        if typ not in self.SUPPORTED:
            raise ConnectorException(f"segment.io message type {typ!r} not supported")
        user = payload.get("userId") or payload.get("anonymousId")
        if not user:
            raise ConnectorException("segment.io payload has no userId/anonymousId")
        props: dict = {}
        if typ == "identify":
            props = dict(payload.get("traits") or {})
        elif typ == "track":
            props = {
                "event": payload.get("event"),
                "properties": payload.get("properties") or {},
            }
        elif typ in ("page", "screen"):
            props = {
                "name": payload.get("name"),
                "properties": payload.get("properties") or {},
            }
        elif typ == "alias":
            props = {"previousId": payload.get("previousId")}
        elif typ == "group":
            props = {
                "groupId": payload.get("groupId"),
                "traits": payload.get("traits") or {},
            }
        if payload.get("context") is not None:
            props["context"] = payload["context"]
        return {
            "event": typ,
            "entityType": "user",
            "entityId": str(user),
            "properties": {k: v for k, v in props.items() if v is not None},
            "eventTime": payload.get("timestamp") or payload.get("sentAt"),
        }


class MailChimpConnector:
    """MailChimp webhook form posts → events (reference
    MailChimpConnector.scala — subscribe/unsubscribe/profile/upemail/
    cleaned/campaign)."""

    SUPPORTED = (
        "subscribe", "unsubscribe", "profile", "upemail", "cleaned", "campaign",
    )

    def to_event_json_from_form(self, form: Mapping[str, str]) -> dict:
        typ = form.get("type")
        if typ not in self.SUPPORTED:
            raise ConnectorException(f"mailchimp event type {typ!r} not supported")
        fired_at = form.get("fired_at")
        # mailchimp nests fields as data[...] form keys
        data = {
            k[len("data["):-1]: v
            for k, v in form.items()
            if k.startswith("data[") and k.endswith("]")
        }
        if typ == "cleaned":
            entity_id = data.get("email", "")
        elif typ == "campaign":
            entity_id = data.get("id", "")
        else:
            entity_id = data.get("id", "")
        if not entity_id:
            raise ConnectorException(f"mailchimp {typ} payload missing id")
        entity_type = "campaign" if typ == "campaign" else "user"
        props = dict(data)
        return {
            "event": typ,
            "entityType": entity_type,
            "entityId": entity_id,
            "properties": props,
            "eventTime": f"{fired_at.replace(' ', 'T')}Z" if fired_at else None,
        }


# registry (reference WebhooksConnectors.scala)
JSON_CONNECTORS: dict[str, JsonConnector] = {
    "segmentio": SegmentIOConnector(),
    "examplejson": ExampleJsonConnector(),
}
FORM_CONNECTORS: dict[str, FormConnector] = {
    "mailchimp": MailChimpConnector(),
    "exampleform": ExampleFormConnector(),
}
