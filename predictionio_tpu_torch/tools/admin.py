"""Admin REST API (default port 7071).

Counterpart of the JAX package's ``tools/admin.py`` (reference
tools/.../admin/AdminAPI.scala:35,132 and CommandClient.scala:58), the
port's own copy. A REST mirror of the console's app commands:

  GET    /                     → server status
  GET    /cmd/app              → list apps
  POST   /cmd/app              → create app {"name": ...}
  DELETE /cmd/app/{name}       → delete app
  DELETE /cmd/app/{name}/data  → wipe the app's event data

The model-lifecycle control plane, all storage-backed, so any admin
server over the shared stores sees the same queue and registry:

  GET    /jobs                 → list train jobs (?status= filter)
  POST   /jobs                 → submit {"variant": {...}, "period_s"?, ...}
  GET    /jobs/{id}            → one job record
  GET    /jobs/{id}/logs       → the job's log file (text)
  GET    /models               → model versions (?engine=&status= filters)
  GET    /models/{id}          → one version (+lineage)
  POST   /models/{id}/promote  → mark live (the previous live → archived)
  POST   /models/{id}/rollback → mark rolled_back {"reason"?}
  GET    /rollout              → registry view of canary and live versions
  POST   /rollout              → proxy start/abort/status to a query
                                 server: {"url", "action", ...} (403
                                 unless PIO_ROLLOUT_PROXY=1)
  GET    /online               → every online consumer's cursor record
  GET    /evals                → fleet eval runs (?engine=&status=&tenant=)
  GET    /evals/{run}          → one run's live status (points, shards)

The multi-tenant control plane: tenant records are storage-backed too,
so every query server's multiplexer sees an edit within its refresh:

  GET    /tenants              → list tenants
  POST   /tenants              → create or update {"id", "engine_id", ...}
  GET    /tenants/{id}         → one tenant record
  POST   /tenants/{id}/quota   → set weight, qps, concurrency, device
                                 quota, deadline floor
  DELETE /tenants/{id}         → delete a tenant

and the routes every server shares (``/metrics``, ``/alerts``,
``/debug/traces``, ``/debug/tsdb``, ``/debug/profile``,
``/debug/faults``, ``POST /debug/profile/capture``). Standard library
only: the server loads no torch.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Optional
from urllib.parse import parse_qsl, urlsplit

from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.deploy.registry import LifecycleRecordStore, ModelRegistry
from predictionio_tpu_torch.deploy.scheduler import JobQueue
from predictionio_tpu_torch.evalfleet.driver import EvalDriver
from predictionio_tpu_torch.evalfleet.records import EvalRecordStore
from predictionio_tpu_torch.obs import server_registry
from predictionio_tpu_torch.tenancy.tenants import QUOTA_FIELDS, Tenant, TenantStore
from predictionio_tpu_torch.tools import common
from predictionio_tpu_torch.tools.common import CommandError
from predictionio_tpu_torch.utils.env import env_flag
from predictionio_tpu_torch.utils.http import (
    HttpError,
    JsonHandler,
    ServerProcess,
    ThreadedServer,
)

class _Handler(JsonHandler):
    server: "_Server"  # type: ignore[assignment]

    @property
    def storage(self) -> Storage:
        return self.server.storage

    def _query_params(self) -> dict[str, str]:
        return dict(parse_qsl(urlsplit(self.path).query))

    def do_GET(self):
        self._drain_body()
        path = self.path.split("?")[0].rstrip("/") or "/"
        parts = [p for p in path.split("/") if p]
        try:
            if path == "/":
                self._respond(200, {"status": "alive"})
            elif path == "/metrics":
                self._serve_metrics()
            elif path == "/alerts":
                self._serve_alerts()
            elif path == "/debug/traces":
                self._serve_debug_traces()
            elif path == "/debug/tsdb":
                self._serve_debug_tsdb()
            elif path == "/debug/profile":
                self._serve_debug_profile()
            elif path == "/debug/faults":
                self._serve_debug_faults()
            elif parts[:1] == ["jobs"]:
                self._get_jobs(parts)
            elif parts[:1] == ["models"]:
                self._get_models(parts)
            elif parts[:1] == ["evals"]:
                self._get_evals(parts)
            elif parts[:1] == ["tenants"]:
                self._get_tenants(parts)
            elif path == "/rollout":
                self._get_rollout()
            elif path == "/online":
                self._get_online()
            elif path == "/cmd/app":
                apps = self.storage.get_meta_data_apps().get_all()
                keys = self.storage.get_meta_data_access_keys()
                self._respond(200, [
                    {"name": a.name, "id": a.id, "description": a.description,
                     "accessKeys": [k.key for k in keys.get_by_app_id(a.id)]}
                    for a in sorted(apps, key=lambda a: a.id)
                ])
            else:
                raise HttpError(404, "Not Found")
        except HttpError as e:
            self._respond(e.status, {"message": e.message})

    def do_POST(self):
        self._drain_body()
        path = self.path.split("?")[0].rstrip("/")
        parts = [p for p in path.split("/") if p]
        try:
            if path == "/cmd/app":
                obj = self._json_body()
                if not isinstance(obj, dict) or not obj.get("name"):
                    raise HttpError(400, "app 'name' is required")
                raw_id = obj.get("id") or 0
                if not isinstance(raw_id, int) or isinstance(raw_id, bool):
                    raise HttpError(400, "app 'id' must be an integer")
                try:
                    app, key = common.create_app(
                        self.storage, obj["name"], description=obj.get("description"),
                        app_id=raw_id)
                except CommandError as e:
                    raise HttpError(409, str(e))
                self._respond(201, {"name": app.name, "id": app.id, "accessKey": key})
            elif path == "/jobs":
                self._post_job()
            elif path == "/tenants":
                self._post_tenant()
            elif path.startswith("/tenants/"):
                self._post_tenant_quota(parts)
            elif path.startswith("/models/"):
                self._post_model(parts)
            elif path == "/rollout":
                self._post_rollout()
            elif path == "/debug/profile/capture":
                self._serve_profile_capture()
            elif path == "/debug/faults":
                self._serve_debug_faults_set()
            else:
                raise HttpError(404, "Not Found")
        except HttpError as e:
            self._respond(e.status, {"message": e.message})

    def do_DELETE(self):
        self._drain_body()
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        try:
            if len(parts) >= 2 and parts[:2] == ["cmd", "app"]:
                if len(parts) == 3:
                    self._delete_app(parts[2])
                elif len(parts) == 4 and parts[3] == "data":
                    self._delete_data(parts[2])
                else:
                    raise HttpError(404, "Not Found")
            elif len(parts) == 2 and parts[0] == "tenants":
                self._delete_tenant(parts[1])
            else:
                raise HttpError(404, "Not Found")
        except HttpError as e:
            self._respond(e.status, {"message": e.message})

    # -- the model-lifecycle control plane ----------------------------------
    def _get_jobs(self, parts: list[str]) -> None:
        queue = self.server.job_queue
        if len(parts) == 1:
            status = self._query_params().get("status")
            self._respond(200, [j.to_dict() for j in queue.list(status=status)])
            return
        job = queue.get(parts[1])
        if job is None:
            raise HttpError(404, f"no job {parts[1]!r}")
        if len(parts) == 2:
            self._respond(200, job.to_dict())
        elif len(parts) == 3 and parts[2] == "logs":
            if not job.log_path:
                raise HttpError(404, f"job {job.id} has no log yet")
            try:
                with open(job.log_path, "rb") as f:
                    data = f.read().decode(errors="replace")
            except OSError as e:
                raise HttpError(404, f"job log unreadable: {e}")
            self._respond(200, data, "text/plain")
        else:
            raise HttpError(404, "Not Found")

    def _post_job(self) -> None:
        obj = self._json_body()
        if not isinstance(obj, dict) or not isinstance(obj.get("variant"), dict):
            raise HttpError(400, "job body must carry a 'variant' object")
        try:
            job = self.server.job_queue.submit(
                obj["variant"], engine_id=obj.get("engine_id"),
                timeout_s=obj.get("timeout_s"), period_s=obj.get("period_s"),
                max_attempts=int(obj.get("max_attempts", 3)))
        except (ValueError, TypeError) as e:
            raise HttpError(400, str(e))
        self._respond(201, job.to_dict())

    def _get_evals(self, parts: list[str]) -> None:
        """The fleet evaluation's runs, newest first, or one run's
        status recomputed from the durable records."""
        if len(parts) == 1:
            q = self._query_params()
            self._respond(200, [r.to_dict() for r in self.server.eval_records.list_runs(
                engine_id=q.get("engine"), status=q.get("status"), tenant=q.get("tenant"))])
        elif len(parts) == 2:
            try:
                self._respond(200, EvalDriver(self.storage).status(parts[1]))
            except KeyError:
                raise HttpError(404, f"no eval run {parts[1]!r}")
        else:
            raise HttpError(404, "Not Found")

    def _get_models(self, parts: list[str]) -> None:
        registry = self.server.model_registry
        if len(parts) == 1:
            q = self._query_params()
            self._respond(200, [v.to_dict() for v in registry.list(
                engine_id=q.get("engine"), status=q.get("status"))])
            return
        version = registry.get(parts[1])
        if version is None:
            raise HttpError(404, f"no model version {parts[1]!r}")
        self._respond(200, dict(version.to_dict(),
                                lineage=[v.id for v in registry.lineage(version.id)]))

    def _post_model(self, parts: list[str]) -> None:
        if len(parts) != 3 or parts[2] not in ("promote", "rollback"):
            raise HttpError(404, "Not Found")
        registry = self.server.model_registry
        body = self._json_body()
        reason = (body.get("reason") if isinstance(body, dict) else None
                  ) or "operator request"
        try:
            if parts[2] == "promote":
                version = registry.promote(parts[1])
            else:
                version = registry.rollback(parts[1], reason)
        except KeyError as e:
            raise HttpError(404, str(e.args[0] if e.args else e))
        self._respond(200, version.to_dict())

    # -- the multi-tenant control plane --------------------------------------
    def _get_tenants(self, parts: list[str]) -> None:
        store = self.server.tenant_store
        if len(parts) == 1:
            self._respond(200, [t.to_dict() for t in store.list()])
            return
        if len(parts) != 2:
            raise HttpError(404, "Not Found")
        tenant = store.get(parts[1])
        if tenant is None:
            raise HttpError(404, f"no tenant {parts[1]!r}")
        self._respond(200, tenant.to_dict())

    def _post_tenant(self) -> None:
        obj = self._json_body()
        if not isinstance(obj, dict):
            raise HttpError(400, "tenant body must be a JSON object")
        try:
            tenant = Tenant.from_dict(obj)
        except (TypeError, ValueError) as e:
            raise HttpError(400, str(e))
        existed = self.server.tenant_store.get(tenant.id) is not None
        self.server.tenant_store.upsert(tenant)
        self._respond(200 if existed else 201, tenant.to_dict())

    def _post_tenant_quota(self, parts: list[str]) -> None:
        if len(parts) != 3 or parts[2] != "quota":
            raise HttpError(404, "Not Found")
        obj = self._json_body()
        if not isinstance(obj, dict):
            raise HttpError(400, "quota body must be a JSON object")
        fields = {k: obj[k] for k in QUOTA_FIELDS if k in obj}
        if not fields:
            raise HttpError(400, f"quota body needs at least one of {', '.join(QUOTA_FIELDS)}")
        try:
            tenant = self.server.tenant_store.set_quota(parts[1], **fields)
        except KeyError:
            raise HttpError(404, f"no tenant {parts[1]!r}")
        except (TypeError, ValueError) as e:
            raise HttpError(400, str(e))
        self._respond(200, tenant.to_dict())

    def _delete_tenant(self, tenant_id: str) -> None:
        if not self.server.tenant_store.delete(tenant_id):
            raise HttpError(404, f"no tenant {tenant_id!r}")
        self._respond(200, {"message": f"tenant {tenant_id!r} deleted"})

    def _get_rollout(self) -> None:
        """The registry's rollout view: what is live and what is baking,
        per engine variant (the query server's /rollout/status has the
        live traffic windows)."""
        versions = self.server.model_registry.list()  # one fold
        self._respond(200, {
            "canary": [v.to_dict() for v in versions if v.status == "canary"],
            "live": [v.to_dict() for v in versions if v.status == "live"],
        })

    def _get_online(self) -> None:
        """Storage's view of online learning: every consumer's durable
        cursor record (where each tail stands, the cumulative fold
        counters). The query server's /online/status has the live state."""
        from predictionio_tpu_torch.online.consumer import CURSOR_ENTITY

        records = LifecycleRecordStore(self.storage).fold(CURSOR_ENTITY)
        self._respond(200, {"consumers": [dict(rec, cursor_id=cid)
                                          for cid, rec in sorted(records.items())]})

    def _post_rollout(self) -> None:
        """Proxy a rollout action to the query server that owns the
        runtimes: {"url": "http://host:8000", "action":
        "start|abort|status", ...verdict overrides}. Fetching a
        caller-supplied URL is an SSRF primitive, so the proxy is off
        unless the operator set PIO_ROLLOUT_PROXY=1 (the console's
        `rollout` talks to the query server directly)."""
        if not env_flag("PIO_ROLLOUT_PROXY"):
            raise HttpError(403, "rollout proxy is disabled: set "
                                 "PIO_ROLLOUT_PROXY=1 on this server to enable it")
        obj = self._json_body()
        if not isinstance(obj, dict) or not obj.get("url"):
            raise HttpError(400, "rollout body must carry the query server 'url'")
        action = obj.get("action", "start")
        if action not in ("start", "abort", "status"):
            raise HttpError(400, f"unknown rollout action {action!r}")
        parts = urlsplit(obj["url"])
        # scheme, host and port only: a path or query would smuggle the
        # appended /rollout/<action> into another route
        if parts.scheme not in ("http", "https") or not parts.netloc or (
                parts.path not in ("", "/") or parts.query or parts.fragment):
            raise HttpError(400, "rollout 'url' must be http(s)://host[:port] only")
        base = f"{parts.scheme}://{parts.netloc}"
        payload = {k: v for k, v in obj.items() if k not in ("url", "action")}
        try:
            if action == "status":
                req = urllib.request.Request(f"{base}/rollout/status")
            else:
                req = urllib.request.Request(
                    f"{base}/rollout/{action}", data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                raw = r.read().decode(errors="replace")
                try:
                    body = json.loads(raw)
                except ValueError:
                    # a wrong port (an HTML server answers 200): a clean 502
                    raise HttpError(502, f"query server returned non-JSON: {raw[:200]}")
                self._respond(r.status, body)
        except urllib.error.HTTPError as e:
            body = e.read().decode(errors="replace")
            try:
                self._respond(e.code, json.loads(body))
            except ValueError:
                self._respond(e.code, {"message": body})
        except OSError as e:
            raise HttpError(502, f"query server unreachable: {e}")

    def _app(self, name: str) -> App:
        app = self.storage.get_meta_data_apps().get_by_name(name)
        if app is None:
            raise HttpError(404, f"App {name!r} does not exist.")
        return app

    def _delete_app(self, name: str) -> None:
        common.delete_app(self.storage, self._app(name))
        self._respond(200, {"message": f"App {name!r} deleted."})

    def _delete_data(self, name: str) -> None:
        common.delete_app_data(self.storage, self._app(name), all_channels=True)
        self._respond(200, {"message": f"Event data of app {name!r} deleted."})


class _Server(ThreadedServer):
    def __init__(self, addr, storage: Storage):
        super().__init__(addr, _Handler)
        self.storage = storage
        # one registry and queue a server, not a request: their
        # memoization (a storage round trip) lives on them
        self.model_registry = ModelRegistry(storage)
        self.job_queue = JobQueue(storage)
        self.tenant_store = TenantStore(storage)
        self.eval_records = EvalRecordStore(storage)
        self.metrics = server_registry()
        self.metrics_label = "admin"


class AdminServer(ServerProcess):
    _name = "admin-server"

    def __init__(self, storage: Optional[Storage] = None, ip: str = "0.0.0.0",
                 port: int = 7071):
        super().__init__()
        self.storage = storage or Storage()
        self.ip = ip
        self.port_config = port

    def _make_server(self) -> _Server:
        return _Server((self.ip, self.port_config), self.storage)
