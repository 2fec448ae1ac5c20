"""The simulator HTTP server (stdlib ThreadingHTTPServer).

Routes mirror the reference echo server exactly (reference
simulator/server/server.go:44-54, handlers under server/handler/):

    GET  /api/v1/schedulerconfiguration      -> current KubeSchedulerConfiguration
    POST /api/v1/schedulerconfiguration      -> apply (only .profiles/.extenders
                                                taken, schedulerconfig.go:42-64),
                                                202 on success, 500 on failure
    PUT  /api/v1/reset                       -> restore boot state, 202
    GET  /api/v1/export                      -> snapshot JSON (ResourcesForSnap)
    POST /api/v1/import                      -> load snapshot, 200
    GET  /api/v1/listwatchresources          -> streaming watch: newline-delimited
                                                {"Kind","EventType","Obj"} JSON
                                                (streamwriter.go:41-50); per-kind
                                                ?XXXlastResourceVersion= resumes
                                                (watcher.go:23-46)
    POST /api/v1/extender/{filter,prioritize,preempt,bind}/:id
                                             -> extender webhook proxy
                                                (server.go:88-93)

Beyond the reference surface: /api/v1/resources/* CRUD (the role the
KWOK apiserver plays for the reference UI), GET /api/v1/metrics (the
merged evidence document: scheduler counters + latency histograms +
fault-plane counters + replay driver stats + the job plane's queue/
worker/per-job section), GET /metrics (the same as Prometheus text), GET
/api/v1/trace (the trace plane's event ring as Chrome trace-event
JSON), GET /api/v1/traces (the traces registered in the operator's
KSIM_TRACES_DIR), the Permit waiting-pod view/ops (GET
/api/v1/waitingpods, POST /api/v1/waitingpods/<ns>/<name>/{allow,reject}
— the framework handle's WaitingPod surface for external permit
controllers), and the tenant job plane (jobs/manager.py):

    POST   /api/v1/jobs                 -> submit a scenario job
                                           (202 {job}, 400 bad spec,
                                           413 over per-job bounds,
                                           429 queue full or tenant
                                           throttled — the throttle
                                           carries Retry-After)
    GET    /api/v1/jobs                 -> list job statuses
    GET    /api/v1/jobs/<id>            -> one job's status
    GET    /api/v1/jobs/<id>/result     -> final result document
                                           (409 until terminal)
    GET    /api/v1/jobs/<id>/events     -> SSE stream of progress +
                                           trace events
    GET    /api/v1/jobs/<id>/trace      -> the job's private ring as
                                           Chrome trace JSON
    DELETE /api/v1/jobs/<id>            -> cancel (queued: immediate;
                                           running: cooperative, the
                                           in-flight segment rolls
                                           back)

The port of ``ksim_tpu/server/http.py``, route for route: a job's
replay runs on the container's device (kernel D on the card for a
device-replay job).

CORS headers come from ``cors_allowed_origins`` (the reference reads them
from config, server.go:28-32)."""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ksim_tpu_torch.engine.compilecache import COMPILE_CACHE
from ksim_tpu_torch.faults import FAULTS
from ksim_tpu_torch.obs import (
    TRACE,
    merge_chrome_traces,
    merge_fleet_docs,
    process_identity,
    provider_snapshots,
    read_fleet_snapshots,
    read_fleet_traces,
    render_prometheus,
)
from ksim_tpu_torch.server.di import DIContainer

logger = logging.getLogger(__name__)

# Query-parameter names per kind (reference handler/watcher.go:26-34 —
# note the singular "namespace" prefix).
from ksim_tpu_torch.server.params import LRV_PARAMS

EXTENDER_VERBS = ("filter", "prioritize", "preempt", "bind")


def _sse_heartbeat_s() -> float:
    """Idle bound before the job SSE stream emits a ``: keepalive``
    comment — ``KSIM_JOBS_SSE_HEARTBEAT_S`` (seconds, default 15; 0
    disables).  Proxies and LBs silently drop idle chunked responses;
    the comment line is invisible to EventSource consumers but keeps
    the connection (and the server's disconnect detection) live."""
    raw = os.environ.get("KSIM_JOBS_SSE_HEARTBEAT_S", "")
    try:
        return float(raw) if raw else 15.0
    except ValueError:
        return 15.0



class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: "SimulatorServer"

    # -- plumbing -----------------------------------------------------------

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.debug("%s %s", self.address_string(), fmt % args)

    def _cors(self) -> None:
        origins = self.server.cors_allowed_origins
        origin = self.headers.get("Origin")
        if origins and origin and (origin in origins or "*" in origins):
            self.send_header("Access-Control-Allow-Origin", origin)
            self.send_header("Access-Control-Allow-Credentials", "true")

    def _json(
        self, code: int, obj, headers: "dict[str, str] | None" = None
    ) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self._cors()
        self.send_header("Content-Type", "application/json")
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _no_content(self, code: int) -> None:
        self.send_response(code)
        self._cors()
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _body(self):
        """Request body as an object.  JSON by default; a YAML
        Content-Type parses as YAML — the reference UI's lingua franca
        (its Monaco editors edit resources/config as YAML,
        web/components/ResourceBar/YamlEditor.vue), so pasted manifests
        round-trip without client-side conversion."""
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b""
        if not raw:
            return {}
        if "yaml" in (self.headers.get("Content-Type") or ""):
            import yaml

            return yaml.safe_load(raw)
        return json.loads(raw)

    def _wants_yaml(self, query: dict | None) -> bool:
        fmt = (query or {}).get("format", [""])[0]
        return fmt == "yaml" or "yaml" in (self.headers.get("Accept") or "")

    def _yaml(self, code: int, obj) -> None:
        import yaml

        body = yaml.safe_dump(obj, sort_keys=False).encode()
        self.send_response(code)
        self._cors()
        self.send_header("Content-Type", "application/yaml; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _object(self, code: int, obj, query: dict | None = None) -> None:
        if self._wants_yaml(query):
            self._yaml(code, obj)
        else:
            self._json(code, obj)

    # -- chunked server push (listwatch + the job SSE stream) ---------------

    def _write_chunk(self, payload: bytes) -> bool:
        """One HTTP/1.1 chunk, flushed; False when the client is gone.
        Any OSError means gone — an aborted reader can surface as
        ETIMEDOUT/EPIPE wrapped in plain OSError, not just the two
        connection subclasses."""
        try:
            self.wfile.write(f"{len(payload):x}\r\n".encode() + payload + b"\r\n")
            self.wfile.flush()
            return True
        except OSError:
            return False

    def _end_chunks(self) -> None:
        """Graceful end-of-stream (the zero-length terminal chunk)."""
        try:
            self.wfile.write(b"0\r\n\r\n")
        except OSError:
            pass

    # -- routing ------------------------------------------------------------

    def do_OPTIONS(self) -> None:  # CORS preflight
        self.send_response(204)
        self._cors()
        self.send_header("Access-Control-Allow-Methods", "GET, POST, PUT, DELETE, OPTIONS")
        self.send_header("Access-Control-Allow-Headers", "Content-Type")
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_GET(self) -> None:
        url = urlparse(self.path)
        if url.path in ("/", "/index.html"):
            from ksim_tpu_torch.server.ui import INDEX_HTML

            body = INDEX_HTML.encode()
            self.send_response(200)
            self._cors()
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif url.path == "/api/v1/schedulerconfiguration":
            self._object(
                200,
                self.server.di.scheduler_service.get_scheduler_config(),
                parse_qs(url.query),
            )
        elif url.path == "/api/v1/export":
            self._json(200, self.server.di.snapshot_service.snap())
        elif url.path == "/api/v1/metrics":
            # ?scope=fleet folds every published worker snapshot (plus
            # this process's live document) into one fleet document —
            # counters sum, histograms merge bucket-wise exactly, dead
            # workers surface flagged.
            if (parse_qs(url.query).get("scope") or [""])[0] == "fleet":
                self._json(200, self._fleet_metrics())
            else:
                self._json(200, self._merged_metrics())
        elif url.path == "/metrics":
            # Prometheus/OpenMetrics text exposition of the same
            # evidence (solo by default, ?scope=fleet for the merge).
            self._prometheus(parse_qs(url.query))
        elif url.path == "/api/v1/trace":
            # The live event ring as Chrome trace-event JSON — load the
            # response body straight into Perfetto (ui.perfetto.dev) or
            # chrome://tracing.  Empty unless the trace plane's ring is
            # on (KSIM_TRACE_OUT / KSIM_TRACE=1 / TRACE.enable()).
            # ?scope=fleet merges the frontdoor ring with every
            # published worker trace export: one process lane per
            # worker, flow arrows stitching submit -> claim -> run.
            if (parse_qs(url.query).get("scope") or [""])[0] == "fleet":
                self._json(200, self._fleet_trace())
            else:
                self._json(200, TRACE.export_chrome())
        elif url.path == "/api/v1/traces":
            # The named-trace registry (traces/registry.py):
            # names plus advisory metadata — resolution and parsing
            # stay server-side, and the detected format never overrides
            # the format a job spec names explicitly.
            from ksim_tpu_torch.traces.registry import list_trace_entries

            self._json(200, {"items": list_trace_entries()})
        elif url.path == "/api/v1/waitingpods":
            # Permit-parked pods (the framework handle's waiting-pod view).
            self._json(200, {"items": self.server.di.scheduler_service.get_waiting_pods()})
        elif url.path == "/api/v1/listwatchresources":
            self._list_watch(parse_qs(url.query))
        elif url.path == "/api/v1/jobs" or url.path.startswith("/api/v1/jobs/"):
            self._job_get(url.path)
        elif url.path.startswith("/api/v1/resources/"):
            self._resource("GET", url.path, parse_qs(url.query))
        else:
            self._json(404, {"message": "Not Found"})

    def do_POST(self) -> None:
        url = urlparse(self.path)
        if url.path == "/api/v1/schedulerconfiguration":
            self._apply_scheduler_config()
        elif url.path == "/api/v1/jobs":
            self._job_submit()
        elif url.path == "/api/v1/import":
            try:
                self.server.di.snapshot_service.load(self._body())
            except Exception:
                logger.exception("failed to load snapshot")
                self._json(400, {"message": "Bad Request"})
                return
            self._no_content(200)
        elif url.path.startswith("/api/v1/extender/"):
            self._extender(url.path)
        elif url.path.startswith("/api/v1/waitingpods/"):
            self._waiting_pod_op(url.path)
        elif url.path.startswith("/api/v1/resources/"):
            self._resource("POST", url.path)
        else:
            self._json(404, {"message": "Not Found"})

    def _waiting_pod_op(self, path: str) -> None:
        """POST /api/v1/waitingpods/<ns>/<name>/{allow,reject} — the
        framework handle's WaitingPod.Allow/Reject over REST (an external
        permit controller's surface; in-process plugins use the service
        API directly)."""
        # Drain the request body FIRST, on every branch: the server keeps
        # HTTP/1.1 connections alive, and unread body bytes would parse as
        # the next request line on a pooled connection.
        try:
            body = self._body() or {}
        except Exception:
            body = {}
        parts = [p for p in path.split("/") if p]  # api v1 waitingpods ns name verb
        if len(parts) != 6 or parts[5] not in ("allow", "reject"):
            self._json(404, {"message": "Not Found"})
            return
        _api, _v1, _wp, ns, name, verb = parts
        svc = self.server.di.scheduler_service
        if verb == "allow":
            ok = svc.allow_waiting_pod(name, ns)
        else:
            ok = svc.reject_waiting_pod(
                name, ns, message=body.get("message") or "rejected"
            )
        if not ok:
            self._json(404, {"message": f"no waiting pod {ns}/{name}"})
            return
        self._json(200, {"status": "ok"})

    def do_PUT(self) -> None:
        url = urlparse(self.path)
        if url.path == "/api/v1/reset":
            try:
                self.server.di.reset_service.reset()
            except Exception:
                logger.exception("failed to reset")
                self._json(500, {"message": "Internal Server Error"})
                return
            self._no_content(202)
        elif url.path.startswith("/api/v1/resources/"):
            self._resource("PUT", url.path)
        else:
            self._json(404, {"message": "Not Found"})

    def do_DELETE(self) -> None:
        url = urlparse(self.path)
        if url.path.startswith("/api/v1/jobs/"):
            self._job_cancel(url.path)
        elif url.path.startswith("/api/v1/resources/"):
            self._resource("DELETE", url.path)
        else:
            self._json(404, {"message": "Not Found"})

    # -- handlers -----------------------------------------------------------

    def _merged_metrics(self) -> dict:
        """One GET = the whole degradation-evidence surface: the
        scheduler's counters + latency histograms, the trace plane's
        span histograms/event counters, every fault-plane site's
        calls/fired counters, the registered evidence providers
        (the live run's ``ReplayDriver.stats()`` under ``"replay"``,
        the process-wide ``compile_cache``), and the job plane's
        ``jobs`` section (queue depth, worker occupancy, per-job status
        and private-plane snapshots)."""
        doc = self.server.di.scheduler_service.metrics.snapshot()
        doc["trace"] = TRACE.snapshot()
        doc["faults"] = FAULTS.snapshot()
        doc.update(provider_snapshots())
        # Present even before any replay ran (the import above also
        # registered it as a provider, so this is a no-op after one).
        doc.setdefault("compile_cache", COMPILE_CACHE.snapshot())
        # The jobs section reports WITHOUT forcing the worker pool into
        # existence: a server never asked to run a job shows the empty
        # shape, not two idle threads.
        jm = self.server.di.job_manager_if_built
        doc["jobs"] = (
            jm.snapshot()
            if jm is not None
            else {
                "queue": {
                    "depth": 0,
                    "capacity": 0,
                    "submitted": 0,
                    "rejected": 0,
                    "bypass_pops": 0,
                },
                "workers": {"pool": 0, "active": 0},
                "tenants": {},
                "jobs": {},
            }
        )
        # The process-identity block (role, worker_id, pid, started_at,
        # uptime_s) — unconditional: the fleet aggregator attributes
        # every snapshot to its producer through it.  Set LAST so no
        # provider can shadow it.
        doc["process"] = process_identity(
            role=jm.role if jm is not None else None,
            worker_id=jm.worker_id if jm is not None else None,
        )
        return doc

    def _fleet_metrics(self) -> dict:
        """``GET /api/v1/metrics?scope=fleet`` — every published worker
        snapshot under ``KSIM_JOBS_DIR/obs/`` plus THIS process's live
        document, folded by ``obs.merge_fleet_docs`` (the live document
        replaces this process's own published file, so the serving
        process is never reported stale to itself)."""
        jm = self.server.di.job_manager_if_built
        jobs_dir = getattr(jm, "jobs_dir", None)
        docs = read_fleet_snapshots(jobs_dir) if jobs_dir else {}
        live = self._merged_metrics()
        ident = live["process"]
        ident["published_at"] = round(time.time(), 3)
        docs[ident["worker_id"]] = live
        return merge_fleet_docs(docs)

    def _fleet_trace(self) -> dict:
        """``GET /api/v1/trace?scope=fleet`` — this process's ring (and
        its jobs' private rings) merged with every published worker
        trace export: one process lane per worker, submit->claim->run
        flow arrows across lanes (``obs.merge_chrome_traces``)."""
        jm = self.server.di.job_manager_if_built
        jobs_dir = getattr(jm, "jobs_dir", None)
        docs = read_fleet_traces(jobs_dir) if jobs_dir else {}
        wid = jm.worker_id if jm is not None else f"w{os.getpid()}"
        local = {wid: TRACE.export_chrome()}
        if jm is not None:
            for job in jm.jobs():
                plane = getattr(job, "trace", None)
                if plane is not None:
                    local[f"{wid}:{job.id}"] = plane.export_chrome()
        docs[wid] = (
            merge_chrome_traces(local) if len(local) > 1 else local[wid]
        )
        return merge_chrome_traces(docs, flows=True)

    def _prometheus(self, query: dict) -> None:
        """``GET /metrics`` — the evidence document as Prometheus text
        exposition (``?scope=fleet`` for the merged fleet document);
        every family name lives in the lint-enforced ``METRIC_NAMES``
        registry and the output round-trips through the in-repo
        ``obs.parse_prometheus`` validator in-suite."""
        scope = (query.get("scope") or [""])[0]
        doc = (
            self._fleet_metrics()
            if scope == "fleet"
            else self._merged_metrics()
        )
        body = render_prometheus(doc).encode()
        self.send_response(200)
        self._cors()
        self.send_header(
            "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
        )
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # -- the job plane ------------------------------------------------------

    def _job_submit(self) -> None:
        """POST /api/v1/jobs: validate + enqueue a tenant scenario job.
        202 with the job status on success; 400 on a bad spec; 429 when
        the bounded queue refuses or the submitting tenant
        (``X-Ksim-Tenant`` header, else ``spec.tenant``) is over its
        quota/rate — the throttle response carries a ``Retry-After``
        header with the token bucket's computed wait."""
        from ksim_tpu_torch.jobs import JobLimitExceeded, JobQueueFull, JobThrottled
        from ksim_tpu_torch.scenario.spec import ScenarioSpecError

        try:
            doc = self._body()
        except Exception:
            self._json(400, {"message": "Bad Request"})
            return
        try:
            jm = self.server.di.job_manager
        except Exception:
            # Lazy construction can fail on operator config (e.g. a
            # malformed KSIM_JOBS_FAULTS) — that is a server-side 500,
            # not the tenant's spec, and must never escape the handler.
            logger.exception("job manager construction failed")
            self._json(500, {"message": "Internal Server Error"})
            return
        try:
            job = jm.submit(doc, tenant=self.headers.get("X-Ksim-Tenant"))
        except ScenarioSpecError as e:
            self._json(400, {"message": str(e)})
            return
        except JobLimitExceeded as e:
            # Payload-too-large, with the bound in the reason body so
            # the tenant can resize instead of guessing.
            self._json(413, {"message": str(e)})
            return
        except JobThrottled as e:
            # Retry-After is whole seconds (RFC 9110), rounded UP so an
            # obedient client never retries into the same empty bucket.
            self._json(
                429,
                {"message": str(e)},
                headers={"Retry-After": str(max(1, int(e.retry_after + 0.999)))},
            )
            return
        except JobQueueFull as e:
            self._json(429, {"message": str(e)})
            return
        except Exception:
            logger.exception("job submission failed")
            self._json(500, {"message": "Internal Server Error"})
            return
        self._json(202, job.status())

    def _job_parts(self, path: str) -> "tuple[str, str] | None":
        parts = [p for p in path.split("/") if p]  # api v1 jobs [id [sub]]
        if len(parts) == 3:
            return "", ""
        if len(parts) == 4:
            return parts[3], ""
        if len(parts) == 5 and parts[4] in ("result", "events", "trace"):
            return parts[3], parts[4]
        return None

    def _job_get(self, path: str) -> None:
        parsed = self._job_parts(path)
        if parsed is None:
            self._json(404, {"message": "Not Found"})
            return
        job_id, sub = parsed
        jm = self.server.di.job_manager_if_built
        if not job_id:
            self._json(
                200,
                {"items": [j.status() for j in jm.jobs()] if jm else []},
            )
            return
        job = jm.get(job_id) if jm else None
        if job is None:
            self._json(404, {"message": f"no job {job_id}"})
            return
        if sub == "":
            self._json(200, job.status())
        elif sub == "result":
            state, result, error = job.result_view()
            if state == "succeeded":
                self._json(200, {"id": job.id, "state": state, **(result or {})})
            elif state in ("failed", "cancelled", "interrupted"):
                self._json(
                    200,
                    {"id": job.id, "state": state, "phase": "Failed", "message": error},
                )
            else:
                self._json(
                    409, {"message": f"job {job_id} is {state}; result not ready"}
                )
        elif sub == "trace":
            # The JOB's private ring — the isolation story made visible:
            # only this tenant's spans/events, every record job-tagged.
            self._json(200, job.trace.export_chrome())
        else:  # events: the SSE stream
            self._job_events(job)

    def _job_events(self, job) -> None:  # ksimlint: thread-role(sse-handler)
        """Server push of one job's progress + trace events as
        Server-Sent Events on a flushed chunked response — the
        listwatchresources streaming pattern (eventproxy.go:66-80)
        wearing SSE framing, so a browser EventSource consumes it
        directly.  The event log replays from the start (late joiners
        see the whole history) and the stream ends after the terminal
        state event.

        Hardened (round 15): the listener is COUNTED on the job
        (``sse_listeners`` in the status document) and the count is
        released in a ``finally`` no matter how the reader goes away —
        an aborted EventSource must never leak a phantom listener.  An
        idle stream emits a ``: keepalive`` SSE comment every
        ``KSIM_JOBS_SSE_HEARTBEAT_S`` seconds, which both defeats
        idle-connection reaping by proxies and turns a silently dead
        socket into a detected disconnect (the chunk write fails)."""
        self.send_response(200)
        self._cors()
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        heartbeat_s = _sse_heartbeat_s()
        idx = 0
        last_write = time.monotonic()
        job.sse_attach()
        try:
            while not self.server.stopping.is_set():
                events, idx, done = job.events_since(idx, timeout=0.25)
                for ev in events:
                    if not self._write_chunk(
                        f"data: {json.dumps(ev)}\n\n".encode()
                    ):
                        return
                    last_write = time.monotonic()
                if done:
                    break
                if (
                    heartbeat_s > 0
                    and time.monotonic() - last_write >= heartbeat_s
                ):
                    if not self._write_chunk(b": keepalive\n\n"):
                        return
                    last_write = time.monotonic()
            self._end_chunks()
        finally:
            job.sse_detach()

    def _job_cancel(self, path: str) -> None:
        parsed = self._job_parts(path)
        if parsed is None or not parsed[0] or parsed[1]:
            self._json(404, {"message": "Not Found"})
            return
        jm = self.server.di.job_manager_if_built
        state = jm.cancel(parsed[0]) if jm else None
        if state is None:
            self._json(404, {"message": f"no job {parsed[0]}"})
            return
        self._json(200, {"id": parsed[0], "state": state})

    def _resource(self, method: str, path: str, query: dict | None = None) -> None:
        """Per-resource CRUD.  The reference UI talks straight to the
        KWOK kube-apiserver for this (web/api/v1/pod.ts etc.); the
        in-memory store takes that role here, so the simulator server
        exposes it:

        - ``GET /api/v1/resources/<kind>[?namespace=ns]`` — list (all
          namespaces unless filtered);
        - item routes: ``<kind>/<name>`` (cluster-scoped) or
          ``<kind>/<ns>/<name>`` (namespaced — both segments required);
        - ``POST <kind>`` create, ``PUT`` item update (path and body
          identity must agree, like the apiserver), ``DELETE`` item."""
        from ksim_tpu_torch.errors import ConflictError, NotFoundError
        from ksim_tpu_torch.state.cluster import KINDS, NAMESPACED_KINDS
        from ksim_tpu_torch.state.resources import name_of, namespace_of

        parts = [p for p in path.split("/") if p]  # api, v1, resources, kind, ...
        kind = parts[3] if len(parts) > 3 else ""
        if kind not in KINDS:
            self._json(404, {"message": f"unknown kind {kind!r}"})
            return
        store = self.server.di.store
        rest = parts[4:]
        namespaced = kind in NAMESPACED_KINDS
        if namespaced and len(rest) == 1 and method != "POST":
            self._json(
                400,
                {"message": f"{kind} item routes need /{kind}/<namespace>/<name>"},
            )
            return
        namespace = rest[0] if namespaced and len(rest) == 2 else ""
        name = rest[-1] if rest else ""
        try:
            if method == "GET" and not name:
                ns_filter = (query or {}).get("namespace", [""])[0]
                self._object(200, {"items": store.list(kind, ns_filter)}, query)
            elif method == "GET":
                self._object(200, store.get(kind, name, namespace), query)
            elif method == "POST":
                self._json(201, store.create(kind, self._body()))
            elif method == "PUT":
                body = self._body()
                if name_of(body) != name or (
                    namespaced and (namespace_of(body) or "default") != namespace
                ):
                    self._json(
                        400,
                        {"message": "path and body name/namespace differ"},
                    )
                    return
                self._json(200, store.update(kind, body))
            elif method == "DELETE":
                store.delete(kind, name, namespace)
                self._no_content(200)
        except NotFoundError:
            self._json(404, {"message": "Not Found"})
        except ConflictError as e:
            self._json(409, {"message": str(e)})
        except Exception:
            logger.exception("resource %s %s failed", method, path)
            self._json(400, {"message": "Bad Request"})

    def _apply_scheduler_config(self) -> None:
        """Only .profiles and .extenders are taken from the payload
        (reference handler/schedulerconfig.go:42-64); failure to compile
        keeps the old config (RestartScheduler rollback) and returns 500."""
        try:
            req = self._body()
        except Exception:
            self._json(400, {"message": "Bad Request"})
            return
        svc = self.server.di.scheduler_service
        cfg = svc.get_scheduler_config()
        cfg["profiles"] = req.get("profiles") or []
        cfg["extenders"] = req.get("extenders") or []
        try:
            svc.apply_scheduler_config(cfg)
        except Exception:
            logger.exception("failed to apply scheduler config")
            self._json(500, {"message": "Internal Server Error"})
            return
        self._no_content(202)

    def _extender(self, path: str) -> None:
        parts = path.split("/")  # ['', 'api', 'v1', 'extender', verb, id]
        if len(parts) != 6 or parts[4] not in EXTENDER_VERBS:
            self._json(404, {"message": "Not Found"})
            return
        svc = self.server.di.extender_service
        if svc is None:
            self._json(400, {"message": "no extenders configured"})
            return
        try:
            idx = int(parts[5])
            if idx < 0:  # Python's negative indexing must not dispatch
                raise IndexError(idx)
            out = getattr(svc, parts[4])(idx, self._body())
        except (IndexError, ValueError):
            self._json(400, {"message": "Bad Request"})
            return
        except Exception:
            logger.exception("extender %s failed", parts[4])
            self._json(500, {"message": "Internal Server Error"})
            return
        self._json(200, out)

    def _list_watch(self, query: dict[str, list[str]]) -> None:
        """Server push: initial LIST as ADDED events for kinds without a
        lastResourceVersion, then live events, as newline-delimited JSON
        on a flushed chunked response (reference eventproxy.go:66-80,
        streamwriter.go:41-50)."""
        store = self.server.di.store
        since: dict[str, int] = {}
        listed: list[str] = []
        from ksim_tpu_torch.state.cluster import KINDS

        for kind in KINDS:
            raw = (query.get(LRV_PARAMS[kind]) or [""])[0]
            if raw:
                try:
                    since[kind] = int(raw)
                except ValueError:
                    listed.append(kind)
            else:
                listed.append(kind)

        # Atomic list+replay+subscribe under the store lock — no gap or
        # duplicate between the initial events and the live stream.  This
        # must happen BEFORE the 200 status goes out: a compacted resume
        # point answers 410 Gone (client drops its cache and relists).
        from ksim_tpu_torch.errors import ExpiredError

        try:
            stream = store.watch(since=since, list_first=tuple(listed))
        except ExpiredError as e:
            self._json(410, {"message": str(e)})
            return

        self.send_response(200)
        self._cors()
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        try:
            while not self.server.stopping.is_set():
                ev = stream.next(timeout=0.25)
                if ev is None:
                    continue
                if not self._write_chunk(json.dumps(ev.to_json()).encode() + b"\n"):
                    return
            # Graceful end-of-stream on server shutdown.
            self._end_chunks()
        finally:
            stream.close()


class SimulatorServer(ThreadingHTTPServer):
    """The simulator's HTTP front end; serve_forever in a daemon thread
    via start(), stoppable via shutdown_server()."""

    daemon_threads = True

    def __init__(
        self,
        di: DIContainer,
        *,
        host: str = "127.0.0.1",
        port: int = 1212,
        cors_allowed_origins: tuple[str, ...] = (),
    ) -> None:
        super().__init__((host, port), _Handler)
        self.di = di
        self.cors_allowed_origins = tuple(cors_allowed_origins)
        self.stopping = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.server_address[1]

    def start(self) -> "SimulatorServer":
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()
        return self

    def shutdown_server(self) -> None:
        self.stopping.set()
        self.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None
        self.server_close()
