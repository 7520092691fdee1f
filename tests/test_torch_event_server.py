"""The port's Event Server against the JAX package's.

- Each case of tests/test_event_server.py but the two segments cases
  (segmentfs is not ported) runs against the port's in-process server,
  on memory and on sqlite storage: status, auth, roundtrip, reserved
  names, malformed JSON, the whitelist, channels, the batch limit, the
  GET filters, stats, input blockers, keep-alive after an error, and the
  three webhooks.
- A seeded script of requests plays against the JAX package's server
  and the port's, each on its own storage of the same kind: every status
  and body is equal once each server's eventIds are mapped, one to one in
  the order they first appear, and the servers' own clocks
  (creationTime of events posted without one, stats' startTime) are
  blanked.
- The routes the port leaves out answer 404 saying so.
"""

import base64
import http.client
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu_torch.data.api.plugins import INPUT_BLOCKER
from predictionio_tpu_torch.data.api.server import EventServer, EventServerConfig
from predictionio_tpu_torch.data.storage import base as tbase
from predictionio_tpu_torch.data.storage import registry as treg


def req(port, path, method="GET", body=None, form=False, raw=None, headers=None):
    url = f"http://127.0.0.1:{port}{path}"
    data, hdrs = raw, dict(headers or {})
    if body is not None:
        if form:
            from urllib.parse import urlencode

            data = urlencode(body).encode()
            hdrs["Content-Type"] = "application/x-www-form-urlencoded"
        else:
            data = json.dumps(body).encode()
            hdrs["Content-Type"] = "application/json"
    r = urllib.request.Request(url, data=data, headers=hdrs, method=method)
    try:
        with urllib.request.urlopen(r, timeout=10) as resp:
            return resp.status, json.loads(resp.read().decode() or "null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "null")


class RejectBlocker:
    plugin_name = "reject-spam"
    plugin_type = INPUT_BLOCKER

    def process(self, event_json, context):
        if event_json.get("event") == "spam":
            raise ValueError("spam is blocked")


def _config(kind, tmp_path, mod):
    """A memory or sqlite StorageConfig of the JAX package (`mod` its
    registry) or of the port."""
    settings = {"PATH": str(tmp_path / "pio.db")} if kind == "sqlite" else {}
    return mod.StorageConfig(
        sources={"S": mod.SourceConfig("S", kind, settings)},
        repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "S"},
    )


def _seed(storage, base):
    """The JAX test's app: keys KEY (all events) and RATEONLY, channel
    ch1."""
    app_id = storage.get_meta_data_apps().insert(base.App(id=0, name="srvapp"))
    storage.get_events().init_app(app_id)
    keys = storage.get_meta_data_access_keys()
    keys.insert(base.AccessKey(key="KEY", app_id=app_id, events=()))
    keys.insert(base.AccessKey(key="RATEONLY", app_id=app_id, events=("rate",)))
    ch_id = storage.get_meta_data_channels().insert(
        base.Channel(id=0, name="ch1", app_id=app_id))
    storage.get_events().init_app(app_id, ch_id)


@pytest.fixture(params=["memory", "sqlite"])
def server(request, tmp_path):
    storage = treg.Storage(_config(request.param, tmp_path, treg))
    _seed(storage, tbase)
    srv = EventServer(storage, EventServerConfig(
        ip="127.0.0.1", port=0, stats=True, plugins=[RejectBlocker()]))
    port = srv.start()
    yield port
    srv.stop()


EVENT = {
    "event": "rate",
    "entityType": "user",
    "entityId": "u1",
    "targetEntityType": "item",
    "targetEntityId": "i1",
    "properties": {"rating": 4.5},
}


def test_status_alive(server):
    assert req(server, "/") == (200, {"status": "alive"})


def test_auth_required_and_invalid(server):
    assert req(server, "/events.json", "POST", EVENT)[0] == 401
    status, body = req(server, "/events.json?accessKey=WRONG", "POST", EVENT)
    assert status == 401 and "Invalid accessKey" in body["message"]
    basic = base64.b64encode(b"KEY:").decode()
    status, body = req(server, "/events.json", "POST", EVENT,
                       headers={"Authorization": f"Basic {basic}"})
    assert status == 201 and "eventId" in body


def test_insert_get_delete_roundtrip(server):
    status, body = req(server, "/events.json?accessKey=KEY", "POST", EVENT)
    assert status == 201
    eid = body["eventId"]
    status, body = req(server, f"/events/{eid}.json?accessKey=KEY")
    assert status == 200
    assert body["event"] == "rate" and body["entityId"] == "u1"
    assert body["properties"] == {"rating": 4.5}
    assert req(server, f"/events/{eid}.json?accessKey=KEY", "DELETE") == (
        200, {"message": "Found"})
    assert req(server, f"/events/{eid}.json?accessKey=KEY")[0] == 404
    assert req(server, f"/events/{eid}.json?accessKey=KEY", "DELETE")[0] == 404


def test_reserved_event_name_rejected(server):
    status, body = req(server, "/events.json?accessKey=KEY", "POST",
                       dict(EVENT, event="$asdf"))
    assert status == 400 and "reserved" in body["message"]


def test_malformed_json_rejected(server):
    status, body = req(server, "/events.json?accessKey=KEY", "POST", raw=b"{not json",
                       headers={"Content-Type": "application/json"})
    assert status == 400 and body["message"].startswith("invalid JSON")


def test_event_whitelist(server):
    assert req(server, "/events.json?accessKey=RATEONLY", "POST", EVENT)[0] == 201
    status, body = req(server, "/events.json?accessKey=RATEONLY", "POST",
                       dict(EVENT, event="buy"))
    assert status == 403 and "not allowed" in body["message"]


def test_channel_routing(server):
    assert req(server, "/events.json?accessKey=KEY&channel=ch1", "POST", EVENT)[0] == 201
    # the event lives in the channel's namespace, not the default one
    status, body = req(server, "/events.json?accessKey=KEY&channel=ch1")
    assert status == 200 and len(body) == 1
    assert req(server, "/events.json?accessKey=KEY")[0] == 404
    status, body = req(server, "/events.json?accessKey=KEY&channel=nope", "POST", EVENT)
    assert status == 401 and "Invalid channel" in body["message"]


def test_batch_mixed_and_limit(server):
    batch = [EVENT, dict(EVENT, event="$bad"), dict(EVENT, entityId="")]
    status, body = req(server, "/batch/events.json?accessKey=KEY", "POST", batch)
    assert status == 200
    assert [r["status"] for r in body] == [201, 400, 400]
    assert "eventId" in body[0]
    status, body = req(server, "/batch/events.json?accessKey=KEY", "POST", [EVENT] * 51)
    assert status == 400 and "less than or equal to 50" in body["message"]
    assert len(req(server, "/events.json?accessKey=KEY&limit=-1")[1]) == 1


def test_get_events_filters(server):
    for i in range(5):
        req(server, "/events.json?accessKey=KEY", "POST",
            dict(EVENT, entityId=f"u{i}", event="view" if i % 2 else "rate",
                 eventTime=f"2024-01-0{i + 1}T00:00:00.000Z"))
    status, body = req(server, "/events.json?accessKey=KEY&event=rate")
    assert status == 200 and [e["entityId"] for e in body] == ["u0", "u2", "u4"]
    status, body = req(server, "/events.json?accessKey=KEY&limit=2")
    assert [e["entityId"] for e in body] == ["u0", "u1"]
    status, body = req(server, "/events.json?accessKey=KEY&limit=2&reversed=true")
    assert [e["entityId"] for e in body] == ["u4", "u3"]
    status, body = req(server, "/events.json?accessKey=KEY&entityId=u3")
    assert len(body) == 1 and body[0]["entityId"] == "u3"
    status, body = req(server, "/events.json?accessKey=KEY&startTime=2024-01-02T00:00:00Z"
                               "&untilTime=2024-01-04T00:00:00Z")
    assert [e["entityId"] for e in body] == ["u1", "u2"]
    assert req(server, "/events.json?accessKey=KEY&entityId=ghost")[0] == 404
    assert req(server, "/events.json?accessKey=KEY&limit=x")[0] == 400


def test_stats(server):
    req(server, "/events.json?accessKey=KEY", "POST", EVENT)
    status, body = req(server, "/stats.json?accessKey=KEY")
    assert status == 200
    counts = body["hours"][0]["counts"]
    assert any(c["event"] == "rate" and c["count"] >= 1 for c in counts)


def test_input_blocker(server):
    status, body = req(server, "/events.json?accessKey=KEY", "POST", dict(EVENT, event="spam"))
    assert status == 403 and "spam is blocked" in body["message"]
    assert req(server, "/events.json?accessKey=KEY&event=spam")[0] == 404  # not stored


def test_keepalive_error_then_success(server):
    """An error response drains the request body, so the next request on
    the same keep-alive connection parses."""
    conn = http.client.HTTPConnection("127.0.0.1", server, timeout=10)
    body = json.dumps(EVENT)
    for key, want in (("WRONG", 401), ("KEY", 201), ("KEY&limit=x", 201)):
        conn.request("POST", f"/events.json?accessKey={key}", body=body,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        r.read()
        assert r.status == want
    conn.request("POST", "/batch/events.json?accessKey=KEY", body=json.dumps([EVENT] * 51),
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    r.read()
    assert r.status == 400
    conn.request("GET", "/events.json?accessKey=KEY&limit=-1")
    r = conn.getresponse()
    assert r.status == 200 and len(json.loads(r.read())) == 2
    conn.close()


def test_webhooks_examplejson(server):
    payload = {"type": "userActionItem", "userId": "as34smg4", "itemId": "kfjd312bc",
               "timestamp": "2026-01-02T00:30:12.984Z",
               "properties": {"context": "mobile"}}
    status, body = req(server, "/webhooks/examplejson.json?accessKey=KEY", "POST", payload)
    assert status == 201
    status, body = req(server, f"/events/{body['eventId']}.json?accessKey=KEY")
    assert body["event"] == "userActionItem" and body["targetEntityId"] == "kfjd312bc"
    assert req(server, "/webhooks/examplejson.json?accessKey=KEY") == (200, {})
    assert req(server, "/webhooks/nope.json?accessKey=KEY")[0] == 404
    assert req(server, "/webhooks/examplejson.json?accessKey=KEY", "POST",
               {"type": "userActionItem"})[0] == 400


def test_webhooks_segmentio(server):
    payload = {"type": "track", "userId": "user123", "event": "Signed Up",
               "properties": {"plan": "Pro"}, "timestamp": "2026-02-23T22:28:55.111Z"}
    status, body = req(server, "/webhooks/segmentio.json?accessKey=KEY", "POST", payload)
    assert status == 201
    status, body = req(server, f"/events/{body['eventId']}.json?accessKey=KEY")
    assert body["event"] == "track" and body["properties"]["event"] == "Signed Up"


def test_webhooks_mailchimp_form(server):
    form = {"type": "subscribe", "fired_at": "2026-02-23 21:35:57",
            "data[id]": "8a25ff1d98", "data[list_id]": "a6b5da1054",
            "data[email]": "api@mailchimp.com"}
    status, body = req(server, "/webhooks/mailchimp.form?accessKey=KEY", "POST", form,
                       form=True)
    assert status == 201
    status, body = req(server, f"/events/{body['eventId']}.json?accessKey=KEY")
    assert body["event"] == "subscribe" and body["entityId"] == "8a25ff1d98"


@pytest.mark.parametrize("path", ["/metrics", "/debug/traces", "/segments/stats"])
def test_left_out_routes_say_not_ported(server, path):
    """The routes still left out answer 404 saying so: /segments/* and
    the /debug routes beside traces and profile. /metrics and
    /debug/traces are served now (tests/test_torch_observability.py),
    so for those the case asks their unported neighbour."""
    left_out = {"/metrics": "/debug/faults", "/debug/traces": "/debug/tsdb"}.get(path, path)
    status, body = req(server, left_out + "?accessKey=KEY")
    assert status == 404 and "not ported" in body["message"]
    if path != left_out:
        r = urllib.request.urlopen(f"http://127.0.0.1:{server}{path}", timeout=10)
        assert r.status == 200 and r.read()


def test_stats_off_by_default():
    storage = treg.Storage(treg.StorageConfig.memory())
    _seed(storage, tbase)
    srv = EventServer(storage, EventServerConfig(ip="127.0.0.1", port=0))
    port = srv.start()
    try:
        status, body = req(port, "/stats.json?accessKey=KEY")
    finally:
        srv.stop()
    assert status == 404 and "--stats" in body["message"]


# ---------------------------------------------------------------------------
# the same script against the JAX server and the port's
# ---------------------------------------------------------------------------


def _script(seed=5):
    """(method, path, body, kind) requests; `{n}` in a path is the n-th
    eventId the server has answered. Every posted event carries its own
    event time, distinct from the others', so that both stores order
    them the same way."""
    rng = np.random.default_rng(seed)
    seconds = iter(range(1, 3600))

    def ev(**kw):
        n = next(seconds)
        base = {"event": str(rng.choice(["rate", "buy", "view"])), "entityType": "user",
                "entityId": f"u{rng.integers(6)}", "targetEntityType": "item",
                "targetEntityId": f"i{rng.integers(5)}",
                "eventTime": f"2024-02-01T00:{n // 60:02d}:{n % 60:02d}."
                             f"{rng.integers(1000):03d}Z"}
        if base["event"] == "rate":
            base["properties"] = {"rating": int(rng.integers(1, 6))}
        return {**base, **kw}

    s = [("GET", "/", None, "json")]
    s += [("POST", "/events.json?accessKey=KEY", ev(), "json") for _ in range(6)]
    s += [
        ("POST", "/events.json", ev(), "json"),
        ("POST", "/events.json?accessKey=WRONG", ev(), "json"),
        ("POST", "/events.json?accessKey=KEY", ev(event="$asdf"), "json"),
        ("POST", "/events.json?accessKey=KEY", ev(event="$set", targetEntityType=None,
                                                  targetEntityId=None,
                                                  properties={"a": [1, 2]}), "json"),
        ("POST", "/events.json?accessKey=KEY", b"{not json", "raw"),
        ("POST", "/events.json?accessKey=KEY", [1, 2], "json"),
        ("POST", "/events.json?accessKey=RATEONLY", ev(event="buy"), "json"),
        ("POST", "/events.json?accessKey=RATEONLY", ev(event="rate"), "json"),
        ("POST", "/events.json?accessKey=KEY", ev(event="spam"), "json"),
        ("POST", "/events.json?accessKey=KEY&channel=ch1", ev(), "json"),
        ("POST", "/events.json?accessKey=KEY&channel=ch1", ev(tags=["t1"], prId="p9"), "json"),
        ("POST", "/events.json?accessKey=KEY&channel=nope", ev(), "json"),
        ("POST", "/batch/events.json?accessKey=KEY",
         [ev(), ev(event="$bad"), ev(entityId=""), ev(), "x"], "json"),
        ("POST", "/batch/events.json?accessKey=RATEONLY",
         [ev(event="rate"), ev(event="buy")], "json"),
        ("POST", "/batch/events.json?accessKey=KEY", [ev() for _ in range(51)], "json"),
        ("POST", "/batch/events.json?accessKey=KEY", {"a": 1}, "json"),
        ("GET", "/events.json?accessKey=KEY", None, "json"),
        ("GET", "/events.json?accessKey=KEY&limit=-1", None, "json"),
        ("GET", "/events.json?accessKey=KEY&limit=3&reversed=true", None, "json"),
        ("GET", "/events.json?accessKey=KEY&event=rate&limit=-1", None, "json"),
        ("GET", "/events.json?accessKey=KEY&entityType=user&entityId=u1&limit=-1", None, "json"),
        ("GET", "/events.json?accessKey=KEY&targetEntityType=item&targetEntityId=i2", None, "json"),
        ("GET", "/events.json?accessKey=KEY&startTime=2024-02-01T00:00:10Z"
                "&untilTime=2024-02-01T00:00:40Z&limit=-1", None, "json"),
        ("GET", "/events.json?accessKey=KEY&channel=ch1", None, "json"),
        ("GET", "/events.json?accessKey=KEY&entityId=ghost", None, "json"),
        ("GET", "/events.json?accessKey=KEY&limit=x", None, "json"),
        ("GET", "/events/{0}.json?accessKey=KEY", None, "json"),
        ("GET", "/events/{3}.json?accessKey=RATEONLY", None, "json"),
        ("DELETE", "/events/{1}.json?accessKey=KEY", None, "json"),
        ("GET", "/events/{1}.json?accessKey=KEY", None, "json"),
        ("DELETE", "/events/{1}.json?accessKey=KEY", None, "json"),
        ("GET", "/events/{7}.json?accessKey=KEY&channel=ch1", None, "json"),
        ("GET", "/stats.json?accessKey=KEY", None, "json"),
        ("POST", "/webhooks/examplejson.json?accessKey=KEY",
         {"type": "userAction", "userId": "w1", "timestamp": "2024-02-02T00:00:00.000Z",
          "properties": {"x": 1}}, "json"),
        ("GET", "/webhooks/segmentio.json?accessKey=KEY", None, "json"),
        ("POST", "/webhooks/segmentio.json?accessKey=KEY",
         {"type": "identify", "userId": "s1", "traits": {"n": "a"},
          "timestamp": "2024-02-02T00:00:01.000Z"}, "json"),
        ("POST", "/webhooks/segmentio.json?accessKey=KEY", {"type": "nope"}, "json"),
        ("POST", "/webhooks/mailchimp.form?accessKey=KEY",
         {"type": "unsubscribe", "fired_at": "2024-02-02 00:00:02", "data[id]": "m1"}, "form"),
        ("GET", "/webhooks/nope.form?accessKey=KEY", None, "json"),
        ("GET", "/events.json?accessKey=KEY&limit=-1", None, "json"),
        ("GET", "/nope", None, "json"),
    ]
    return s


def _play(port, script):
    """Each request's (status, body), with the server's eventIds mapped to
    their order of first appearance and its own clocks blanked."""
    ids: list[str] = []
    out = []

    def norm(x, key=None):
        if isinstance(x, dict):
            return {k: norm(v, k) for k, v in x.items()}
        if isinstance(x, list):
            return [norm(v) for v in x]
        if key == "eventId":
            if x not in ids:
                ids.append(x)
            return f"E{ids.index(x)}"
        if key in ("creationTime", "startTime", "hour"):
            return "T"
        return x

    for method, path, body, kind in script:
        path = path.format(*ids) if "{" in path else path
        if kind == "raw":
            status, got = req(port, path, method, raw=body,
                              headers={"Content-Type": "application/json"})
        else:
            status, got = req(port, path, method, body, form=kind == "form")
        out.append((status, norm(got)))
    return out


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_script_matches_the_jax_server(tmp_path, kind):
    pytest.importorskip("jax")
    import predictionio_tpu.data.storage.base as jbase
    import predictionio_tpu.data.storage.registry as jreg
    from predictionio_tpu.data.api.server import (
        EventServer as JServer,
        EventServerConfig as JConfig,
    )

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jstorage = jreg.Storage(_config(kind, tmp_path / "jax", jreg))
    tstorage = treg.Storage(_config(kind, tmp_path / "port", treg))
    _seed(jstorage, jbase)
    _seed(tstorage, tbase)

    jsrv = JServer(jstorage, JConfig(ip="127.0.0.1", port=0, stats=True, wal_dir=None,
                                     plugins=[RejectBlocker()]))
    tsrv = EventServer(tstorage, EventServerConfig(ip="127.0.0.1", port=0, stats=True,
                                                   plugins=[RejectBlocker()]))
    jport, tport = jsrv.start(), tsrv.start()
    try:
        script = _script()
        assert len(script) >= 40
        want, got = _play(jport, script), _play(tport, script)
    finally:
        jsrv.stop()
        tsrv.stop()
    assert [w[0] for w in want].count(201) >= 10
    for n, (w, g) in enumerate(zip(want, got)):
        assert g == w, (n, script[n][:2])
    assert len(got) == len(want)
