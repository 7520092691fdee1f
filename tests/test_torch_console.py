"""The port's console verbs for apps, channels, access keys, the event
server, import, export and status, against the JAX package's console.

- ``app new`` creates the app's default access key, in the JAX
  package's ``accesskeys`` table, and prints it as the JAX package does.
- One script of ``app``, ``channel`` and ``accesskey`` commands runs
  through both consoles, each over its own storage under
  PIO_FS_BASEDIR: every exit code and every printed row is equal (keys
  generated with ``secrets.token_urlsafe`` blanked). An operator error
  exits 1 with the same ``[ERROR]`` line in both.
- ``export`` → ``import`` round-trips, and the port's export of a
  channel is the JAX package's, line for line.
- The left-out parts exit 1 saying "not ported".
- ``eventserver`` in a process of its own serves events authenticated by
  the key ``app new`` printed.
- ``alerts``, ``tsdb``, ``monitor`` and ``trace --fleet`` over a port
  server print what the JAX console prints over it.
"""

import json
import os
import re
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest

from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.tools import console

ROOT = Path(__file__).resolve().parents[1]
KEY_RE = re.compile(r"[A-Za-z0-9_-]{43}")  # secrets.token_urlsafe(32)


@pytest.fixture
def base(tmp_path, monkeypatch):
    for key in list(os.environ):
        if key.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(key)

    def use(name):
        path = tmp_path / name
        monkeypatch.setenv("PIO_FS_BASEDIR", str(path))
        return path

    return use


def _run(main, argv, capsys):
    """(exit code, stdout, stderr) of one console call; a SystemExit with
    a message is exit code 1 with the message on stderr, as the process
    would show it."""
    try:
        code = main(argv)
        extra = ""
    except SystemExit as e:
        code, extra = (1, f"{e.code}\n") if isinstance(e.code, str) else (e.code, "")
    out, err = capsys.readouterr()
    return code, out, err + extra


def _jax_console():
    pytest.importorskip("jax")
    from predictionio_tpu.data.storage.registry import Storage as JStorage
    from predictionio_tpu.tools import console as jconsole

    def main(argv):
        JStorage.set_instance(None)  # the JAX console's process singleton
        try:
            return jconsole.main(argv)
        finally:
            JStorage.set_instance(None)

    return main


def test_app_new_prints_an_access_key_row_jax_reads(base, capsys):
    pytest.importorskip("jax")
    from predictionio_tpu.data.storage import sqlite as jsqlite

    path = base("store")
    code, out, _ = _run(console.main, ["app", "new", "shop"], capsys)
    assert code == 0
    m = re.search(r"^\[INFO\] Access key: (\S+)$", out, re.M)
    assert m and KEY_RE.fullmatch(m.group(1)), out
    row = jsqlite.SqliteAccessKeys({"PATH": str(path / "pio.db")}).get(m.group(1))
    assert row is not None and (row.app_id, row.events) == (1, ())
    code, out, _ = _run(console.main, ["app", "new", "two", "--access-key", "MYKEY"], capsys)
    assert code == 0 and "[INFO] Access key: MYKEY" in out
    assert Storage().get_meta_data_access_keys().get("MYKEY").app_id == 2


SCRIPT = [
    ["app", "new", "A", "--access-key", "KA"],
    ["app", "new", "B", "--description", "second"],
    ["app", "new", "A"],
    ["app", "new", "C", "--access-key", "KA"],  # the key is taken: C rolls back
    ["app", "list"],
    ["app", "show", "A"],
    ["app", "show", "C"],
    ["channel", "new", "A", "hold"],
    ["channel", "new", "A", "hold"],
    ["channel", "new", "A", "bad name"],
    ["channel", "new", "nope", "x"],
    ["channel", "new", "B", "hold"],
    ["accesskey", "new", "A", "--key", "K2", "--events", "rate,buy"],
    ["accesskey", "new", "A", "--key", "K2"],
    ["accesskey", "new", "nope"],
    ["accesskey", "list"],
    ["accesskey", "list", "A"],
    ["app", "show", "A"],
    ["accesskey", "delete", "K2"],
    ["accesskey", "delete", "K2"],
    ["app", "data-delete", "A", "--channel", "hold", "-f"],
    ["app", "data-delete", "A", "--channel", "nope", "-f"],
    ["app", "data-delete", "A", "-f"],
    ["channel", "delete", "A", "hold"],
    ["channel", "delete", "A", "hold"],
    ["app", "delete", "B", "-f"],
    ["app", "delete", "B", "-f"],
    ["app", "list"],
    ["accesskey", "list"],
]


def test_app_channel_accesskey_commands_match_jax(base, capsys):
    jmain = _jax_console()
    results = {}
    for name, main in (("jax", jmain), ("port", console.main)):
        base(name)
        results[name] = [tuple(KEY_RE.sub("<key>", x) if isinstance(x, str) else x
                               for x in _run(main, argv, capsys)) for argv in SCRIPT]
    for argv, got, want in zip(SCRIPT, results["port"], results["jax"]):
        assert got == want, argv
    codes = [c for c, _, _ in results["port"]]
    assert codes.count(1) == 12 and codes.count(0) == len(SCRIPT) - 12


def _events_file(path, n=60):
    lines = []
    for k in range(n):
        e = {"event": "rate" if k % 3 else "buy", "entityType": "user",
             "entityId": f"u{k % 7}", "targetEntityType": "item",
             "targetEntityId": f"i{k % 5}", "properties": {"rating": k % 5 + 1},
             "eventTime": f"2024-04-01T10:{k // 60:02d}:{k % 60:02d}.000Z",
             "creationTime": "2024-04-02T00:00:00.000Z", "eventId": f"ev{k:03d}"}
        lines.append(json.dumps(e))
    path.write_text("\n".join(lines[::-1]) + "\n")  # not in time order
    return lines


def test_export_import_round_trip_matches_jax(base, tmp_path, capsys):
    jmain = _jax_console()
    events = tmp_path / "events.jsonl"
    lines = _events_file(events)
    exported = {}
    for name, main in (("jax", jmain), ("port", console.main)):
        base(name)
        for argv in (["app", "new", "A", "--access-key", f"K{name}"],
                     ["channel", "new", "A", "hold"],
                     ["import", "--app", "A", "--channel", "hold", "--input", str(events)],
                     ["export", "--app", "A", "--channel", "hold",
                      "--output", str(tmp_path / f"{name}.jsonl")],
                     ["export", "--app", "A", "--output", str(tmp_path / f"{name}_default.jsonl")]):
            code, out, err = _run(main, argv, capsys)
            assert code == 0, (name, argv, err)
        exported[name] = (tmp_path / f"{name}.jsonl").read_text().splitlines()
        assert (tmp_path / f"{name}_default.jsonl").read_text() == ""
    assert [json.loads(x) for x in exported["port"]] == \
        [json.loads(x) for x in exported["jax"]]
    assert len(exported["port"]) == len(lines)
    # the export imports back into another app, and exports the same
    again = tmp_path / "again.jsonl"
    for argv in (["app", "new", "B", "--access-key", "KB"],
                 ["import", "--app", "B", "--input", str(tmp_path / "port.jsonl")],
                 ["export", "--app", "B", "--output", str(again)]):
        assert _run(console.main, argv, capsys)[0] == 0
    strip = [{k: v for k, v in json.loads(x).items() if k != "revision"}
             for x in exported["port"]]
    assert [{k: v for k, v in json.loads(x).items() if k != "revision"}
            for x in again.read_text().splitlines()] == strip
    assert sorted(x["eventId"] for x in strip) == sorted(json.loads(x)["eventId"]
                                                         for x in lines)


@pytest.mark.parametrize("argv", [
    ["eventserver", "--log-url", "http://collector"],
    ["import", "--app", "A", "--input", "x.parquet", "--format", "parquet"],
    ["export", "--app", "A", "--output", "x.parquet", "--format", "parquet"],
])
def test_left_out_parts_say_not_ported(base, capsys, argv):
    base("store")
    code, _, err = _run(console.main, argv, capsys)
    assert code == 1 and "not ported" in err


def test_status_names_the_storage_and_the_device(base, capsys):
    path = base("store")
    assert _run(console.main, ["app", "new", "A"], capsys)[0] == 0
    code, out, _ = _run(console.main, ["status"], capsys)
    assert code == 0
    assert f"EVENTDATA: source PIOSQLITE (sqlite) {path / 'pio.db'}" in out
    assert "OK SqliteAccessKeys" in out and "OK SqliteChannels" in out
    assert "device: " in out and "1 app(s)" in out


def test_eventserver_process_takes_the_app_new_key(base, capsys):
    path = base("store")
    code, out, _ = _run(console.main, ["app", "new", "A"], capsys)
    key = re.search(r"Access key: (\S+)", out).group(1)
    env = {**os.environ, "PIO_FS_BASEDIR": str(path), "PIO_WAL_DIR": str(path / "wal")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.console", "eventserver",
         "--ip", "127.0.0.1", "--port", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        banner = proc.stdout.readline()
        m = re.match(r"\[INFO\] Event Server is listening at http://127\.0\.0\.1:(\d+)\.",
                     banner)
        assert m, (banner, proc.stderr.read() if proc.poll() is not None else "")
        url = f"http://127.0.0.1:{m.group(1)}"
        body = json.dumps({"event": "rate", "entityType": "user", "entityId": "u1",
                           "targetEntityType": "item", "targetEntityId": "i1",
                           "properties": {"rating": 5}}).encode()
        r = urllib.request.Request(f"{url}/events.json?accessKey={key}", data=body,
                                   headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=30) as resp:
            assert resp.status == 201
            eid = json.loads(resp.read())["eventId"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    [app] = Storage().get_meta_data_apps().get_all()
    event = Storage().get_events().get(eid, app.id)
    assert (event.entity_id, event.properties) == ("u1", {"rating": 5})


@pytest.fixture
def monitored_event_server(base):
    """A port Event Server with the process monitor's sampler and SLO
    engine on hour-long ticks (the test samples by hand), an SLO set and
    an external alert; the monitor's settings come back after."""
    from predictionio_tpu_torch.data.api.server import EventServer, EventServerConfig
    from predictionio_tpu_torch.obs.monitor import SLOSpec, get_monitor

    base("store")
    mon = get_monitor()
    saved = mon.sampler_interval_s, mon.slo_interval_s, list(mon._slos)
    mon.sampler_interval_s = mon.slo_interval_s = 3600.0
    srv = EventServer(Storage(), EventServerConfig(ip="127.0.0.1", port=0, wal_dir=None))
    port = srv.start()
    mon.set_slos([SLOSpec(name="event_avail", server="event", route="/events.json"),
                  SLOSpec(name="ev_up", kind="up", instance="ev")])
    mon.raise_alert("online_drift_pause/test", {"drift": 2.0})
    try:
        for _ in range(3):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10).read()
        mon._sampler.sample_once()
        yield f"http://127.0.0.1:{port}", mon
    finally:
        mon.resolve_alert("online_drift_pause/test")
        mon.set_slos(saved[2])
        srv.stop()
        mon.sampler_interval_s, mon.slo_interval_s = saved[0], saved[1]


@pytest.mark.parametrize("argv", [
    ["alerts", "list"], ["alerts", "show", "event_avail"], ["alerts", "show", "nope"],
    ["tsdb", "query"], ["tsdb", "query", "--name", "http_requests_total"],
    ["tsdb", "query", "--name", "http_requests_total", "--labels", "server:event,path:/",
     "--last", "2"],
    ["tsdb", "query", "--name", "cuda_memory_allocated_bytes", "--agg", "quantile",
     "--q", "0.5"],
    ["tsdb", "query", "sum by (path) (http_requests_total)"],
    ["tsdb", "query", "rate(http_requests_total[5m]"],
])
def test_alerts_and_tsdb_over_a_server_match_jax(monitored_event_server, capsys, argv):
    """Both consoles read the port server's /alerts and /debug/tsdb and
    print the same lines and exit codes."""
    url, _mon = monitored_event_server
    got = _run(console.main, argv + ["--url", url], capsys)
    want = _run(_jax_console(), argv + ["--url", url], capsys)
    assert got == want
    if argv == ["alerts", "list"]:
        assert "'online_drift_pause/test'" in got[1].splitlines()[0]
        assert "event_avail: inactive" in got[1]


def test_alerts_and_tsdb_of_this_process(monitored_event_server, capsys):
    _url, mon = monitored_event_server
    code, out, _ = _run(console.main, ["alerts", "list"], capsys)
    first = out.splitlines()[0]
    assert code == 0 and "2 SLO(s), firing: [" in first
    assert "'online_drift_pause/test'" in first
    code, out, _ = _run(console.main, ["tsdb", "query", "--name", "http_requests_total",
                                       "--labels", "server:event", "--agg", "increase"],
                        capsys)
    assert code == 0 and out.startswith("[INFO] increase(http_requests_total, window=300.0s)")
    code, _, err = _run(console.main, ["trace", "list", "--fleet"], capsys)
    assert code == 1 and "no fleet trace collector" in err


def test_monitor_and_fleet_traces_match_jax(monitored_event_server, capsys):
    """`monitor` scrapes a live and a dead target for one pass in each
    console; `trace list --fleet --url` reads a collector's traces."""
    from predictionio_tpu_torch.obs.monitor import TraceCollector

    url, mon = monitored_event_server
    slos = json.dumps([{"name": "ev_up", "kind": "up", "instance": "ev"}])
    argv = ["monitor", "--targets", f"ev={url},dead=http://127.0.0.1:1", "--interval",
            "0.2", "--duration", "0.01", "--slos", slos, "--expr", 'up{instance="ev"}',
            "--expr", 'sum(up{instance="dead"})']
    from predictionio_tpu.obs.monitor import get_monitor as jax_monitor

    outs = []
    try:
        for main in (console.main, _jax_console()):
            code, out, err = _run(main, argv, capsys)
            assert code == 0, err
            # the clock, and the traces each collector assembled from its
            # own process's recorder, which earlier tests filled
            outs.append([re.sub(r"traces=\d+", "traces=N",
                                re.sub(r"\d\d:\d\d:\d\d", "T", line))
                         for line in out.splitlines()])
    finally:
        jax_monitor().set_collector(None)  # the JAX console leaves its collector set
    assert outs[0] == outs[1]
    assert outs[0][0] == "[INFO] T fleet: dead=DOWN ev=up  traces=N"
    assert '[INFO]   expr up{instance="ev"}{instance=ev} = 1' in outs[0]
    assert mon.collector is None
    col = TraceCollector(targets=[("ev", url)], interval_s=1.0, slow_ms=0.0)
    mon.set_collector(col)
    try:
        col.collect_once()
        for argv in (["trace", "list", "--fleet"], ["trace", "show", "--fleet", "nope"]):
            got = _run(console.main, argv + ["--url", url], capsys)
            assert got[0] == (0 if argv[1] == "list" else 1)
            if argv[1] == "list":
                assert got == _run(_jax_console(), argv + ["--url", url], capsys)
                assert "assembled fleet trace(s)" in got[1]
    finally:
        mon.set_collector(None)
