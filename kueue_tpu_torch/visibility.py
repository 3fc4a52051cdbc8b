"""On-demand visibility API (reference pkg/visibility + apis/visibility).

The reference embeds an aggregated API server (server.go:62) serving live
pending-workload summaries straight from the queue manager
(api/v1beta1/pending_workloads_cq.go / _lq.go).  Here the same data is
exposed two ways: typed accessors (``VisibilityService``) and a real HTTP
endpoint (``serve``) speaking the reference's REST shape — which also
doubles as the kueueviz dashboard feed (cmd/kueueviz backend).

When constructed with a serving ``AdmissionService`` the same server
fronts the admission API: ``POST /apis/serving/v1/submit`` (accept /
429-with-Retry-After / 503-draining), ``GET /apis/serving/v1/position``
(idempotency-token status + queue position), ``GET
/apis/serving/v1/pending`` (ingest listing), and ``GET
/apis/serving/v1/stats`` — with the service's live ``kueue_svc_*``
gauges on the existing ``/metrics``.
"""

from __future__ import annotations

import json
import threading
from dataclasses import asdict, dataclass, field
from typing import Optional


@dataclass
class PendingWorkload:
    """reference apis/visibility/v1beta1/types.go:64."""
    name: str
    namespace: str
    local_queue_name: str
    priority: int
    position_in_cluster_queue: int
    position_in_local_queue: int


@dataclass
class PendingWorkloadsSummary:
    """reference apis/visibility/v1beta1/types.go:85."""
    items: list[PendingWorkload] = field(default_factory=list)


class VisibilityService:
    """reference visibility/api/v1beta1 REST storage."""

    def __init__(self, driver):
        self.driver = driver

    def pending_workloads_cq(self, cq_name: str, limit: Optional[int] = None,
                             offset: int = 0) -> PendingWorkloadsSummary:
        """GET .../clusterqueues/{cq}/pendingworkloads
        (pending_workloads_cq.go)."""
        infos = self.driver.queues.pending_workloads_info(cq_name)
        lq_positions: dict[str, int] = {}
        items = []
        for pos, info in enumerate(infos):
            wl = info.obj
            lq = f"{wl.namespace}/{wl.queue_name}"
            lq_pos = lq_positions.get(lq, 0)
            lq_positions[lq] = lq_pos + 1
            if pos < offset:
                continue
            if limit is not None and len(items) >= limit:
                continue
            items.append(PendingWorkload(
                name=wl.name, namespace=wl.namespace,
                local_queue_name=wl.queue_name, priority=wl.priority,
                position_in_cluster_queue=pos,
                position_in_local_queue=lq_pos))
        return PendingWorkloadsSummary(items=items)

    def pending_workloads_lq(self, namespace: str, lq_name: str,
                             limit: Optional[int] = None,
                             offset: int = 0) -> PendingWorkloadsSummary:
        """GET .../localqueues/{lq}/pendingworkloads
        (pending_workloads_lq.go)."""
        lq = self.driver.queues.local_queues.get(f"{namespace}/{lq_name}")
        if lq is None:
            return PendingWorkloadsSummary()
        cq_summary = self.pending_workloads_cq(lq.cluster_queue)
        items = [w for w in cq_summary.items
                 if w.namespace == namespace and w.local_queue_name == lq_name]
        items = items[offset:]
        if limit is not None:
            items = items[:limit]
        return PendingWorkloadsSummary(items=items)

    # -- dashboard feed (kueueviz-equivalent aggregates) ---------------

    def cluster_queues_summary(self) -> dict:
        out = {}
        for name in self.driver.cache.cluster_queue_names():
            cq = self.driver.cache.cluster_queue(name)
            if cq is None:
                continue
            out[name] = {
                "active": cq.active,
                "pending": self.driver.queues.pending_workloads(name),
                "usage": {f"{fr.flavor}/{fr.resource}": v
                          for fr, v in sorted(
                              self.driver.cache.usage(name).items())},
            }
        return out


_DASHBOARD_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>kueue-tpu</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem;color:#222}
 table{border-collapse:collapse;min-width:40rem}
 th,td{border:1px solid #ccc;padding:.35rem .7rem;text-align:left}
 th{background:#f5f5f5}
 .inactive{color:#b00}
 code{background:#f5f5f5;padding:0 .3rem}
</style></head><body>
<h1>kueue-tpu</h1>
<p>Cluster queues (auto-refreshes; endpoints:
<code>/apis/visibility/v1beta1/…</code>, <code>/metrics</code>)</p>
<table id="cqs"><thead><tr>
<th>ClusterQueue</th><th>Status</th><th>Pending</th><th>Usage</th>
</tr></thead><tbody></tbody></table>
<h2>Pending workloads</h2>
<table id="pending"><thead><tr>
<th>#</th><th>Workload</th><th>LocalQueue</th><th>Priority</th>
<th>ClusterQueue</th>
</tr></thead><tbody></tbody></table>
<script>
async function refresh(){
  const r = await fetch('/apis/visibility/v1beta1/clusterqueues');
  const cqs = await r.json();
  const body = document.querySelector('#cqs tbody');
  body.innerHTML = '';
  const pbody = document.querySelector('#pending tbody');
  pbody.innerHTML = '';
  for (const [name, info] of Object.entries(cqs)) {
    const tr = document.createElement('tr');
    tr.innerHTML = `<td>${name}</td>` +
      `<td class="${info.active ? '' : 'inactive'}">` +
      `${info.active ? 'active' : 'inactive'}</td>` +
      `<td>${info.pending}</td>` +
      `<td><code>${JSON.stringify(info.usage)}</code></td>`;
    body.appendChild(tr);
    if (info.pending > 0) {
      const pr = await fetch('/apis/visibility/v1beta1/clusterqueues/' +
                             name + '/pendingworkloads');
      const items = (await pr.json()).items;
      for (const w of items) {
        const tr2 = document.createElement('tr');
        tr2.innerHTML = `<td>${w.position_in_cluster_queue}</td>` +
          `<td>${w.namespace}/${w.name}</td>` +
          `<td>${w.local_queue_name}</td><td>${w.priority}</td>` +
          `<td>${name}</td>`;
        pbody.appendChild(tr2);
      }
    }
  }
}
refresh(); setInterval(refresh, 3000);
</script></body></html>
"""


class VisibilityServer:
    """The aggregated-API-server equivalent: a real HTTP endpoint
    (reference visibility/server.go:62 + kueueviz backend)."""

    def __init__(self, driver, host: str = "127.0.0.1", port: int = 0,
                 admission=None, admin: bool = False):
        self.service = VisibilityService(driver)
        self.admission = admission   # serving.AdmissionService, optional
        self.admin = admin           # lockstep-harness admin endpoints
        self.host = host
        self.port = port
        self._httpd = None
        self._thread = None

    def start(self) -> int:
        from http.server import BaseHTTPRequestHandler
        from urllib.parse import parse_qs, urlsplit

        from .remote import DrainingHTTPServer, state_digest

        service = self.service
        admission = self.admission
        admin_enabled = self.admin
        step_lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send_json(self, body, code=200, headers=()):
                payload = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            def do_POST(self):
                path = self.path.split("?")[0]
                if path.startswith("/admin/"):
                    # lockstep-harness mutations: the distributed soak's
                    # parent drives each shard's service steps through
                    # these barriers instead of a wall-clock serve loop
                    if not admin_enabled or admission is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    if path == "/admin/step":
                        with step_lock:
                            self._send_json(admission.step())
                    elif path == "/admin/drain":
                        with step_lock:
                            clean = admission.drain()
                        self._send_json({"clean": clean})
                    else:
                        self.send_response(404)
                        self.end_headers()
                    return
                # /apis/serving/v1/submit — the admission API: accept /
                # reject-with-retry-after / duplicate, all explicit
                if path != "/apis/serving/v1/submit" \
                        or admission is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    res = admission.submit(
                        name=req["name"],
                        queue_name=req["queue_name"],
                        requests=req.get("requests", {}),
                        priority=int(req.get("priority", 0)),
                        namespace=req.get("namespace", "default"),
                        runtime_s=float(req.get("runtime_s", 0.0)),
                        count=int(req.get("count", 1)),
                        token=req.get("token"))
                except (KeyError, ValueError, json.JSONDecodeError) as e:
                    self._send_json({"error": str(e)}, code=400)
                    return
                body = {"status": res.status, "token": res.token,
                        "seq": res.seq, "reason": res.reason,
                        "duplicate": res.duplicate,
                        "queue_depth": res.queue_depth,
                        "retry_after_s": res.retry_after_s}
                if res.status == "accepted":
                    self._send_json(body)
                elif res.status in ("rejected", "draining"):
                    code = 429 if res.status == "rejected" else 503
                    self._send_json(body, code=code, headers=(
                        ("Retry-After",
                         str(max(1, int(res.retry_after_s + 0.5)))),))
                else:
                    self._send_json(body)

            def do_GET(self):
                if self.path.split("?")[0] == "/healthz":
                    self._send_json({
                        "ok": True,
                        "ready": not getattr(self.server, "draining",
                                             False)})
                    return
                if self.path.split("?")[0] == "/readyz":
                    # readiness the supervisor polls instead of sleeping
                    if getattr(self.server, "draining", False):
                        self._send_json({"ready": False}, code=503)
                    else:
                        self._send_json({"ready": True})
                    return
                if self.path.split("?")[0] == "/admin/digest":
                    if not admin_enabled:
                        self.send_response(404)
                        self.end_headers()
                        return
                    with step_lock:
                        body = {"digest": state_digest(service.driver),
                                "n": len(service.driver.workloads)}
                        if admission is not None:
                            body["cycle"] = admission.cycle_index
                    self._send_json(body)
                    return
                if self.path.split("?")[0] in ("/", "/index.html"):
                    # kueueviz-equivalent dashboard (reference
                    # cmd/kueueviz): live CQ table fed by the visibility
                    # endpoints below
                    payload = _DASHBOARD_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                if self.path.split("?")[0] == "/metrics":
                    # Prometheus exposition (reference secure metrics
                    # endpoint, cmd/kueue/main.go:154-179)
                    driver = service.driver
                    if hasattr(driver, "refresh_resource_metrics"):
                        driver.refresh_resource_metrics()
                    payload = driver.metrics.render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                if self.path.split("?")[0] == "/debug/flightrecorder":
                    # flight-recorder dump (the pkg/debugger analog,
                    # live over HTTP instead of SIGUSR2)
                    driver = service.driver
                    body = {"error": "no obs plane"}
                    if hasattr(driver, "obs"):
                        body = driver.obs.flight.dump()
                        body["events"] = driver.obs.events.report()
                        body["tracing"] = driver.obs.tracing
                    payload = json.dumps(body).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                if self.path.split("?")[0] == "/debug/spans":
                    # Chrome trace-event JSON: open in Perfetto /
                    # chrome://tracing next to jax.profiler traces
                    driver = service.driver
                    body = {"traceEvents": []}
                    if hasattr(driver, "obs"):
                        body = driver.obs.spans_chrome_trace()
                    payload = json.dumps(body).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                url = urlsplit(self.path)
                if url.path.startswith("/apis/serving/v1/"):
                    # serving admission/visibility API (tokens carry
                    # "/" so they travel as a query param)
                    if admission is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    rest = url.path[len("/apis/serving/v1/"):]
                    if rest == "pending":
                        q = parse_qs(url.query)
                        limit = int(q.get("limit", ["100"])[0])
                        self._send_json(admission.pending(limit=limit))
                    elif rest == "position":
                        q = parse_qs(url.query)
                        tok = q.get("token", [""])[0]
                        self._send_json(admission.queue_position(tok))
                    elif rest == "stats":
                        self._send_json(admission.stats())
                    else:
                        self.send_response(404)
                        self.end_headers()
                    return
                parts = [p for p in self.path.split("?")[0].split("/") if p]
                # /apis/visibility/v1beta1/clusterqueues/{cq}/pendingworkloads
                # /apis/visibility/v1beta1/namespaces/{ns}/localqueues/{lq}/pendingworkloads
                # /apis/visibility/v1beta1/clusterqueues
                try:
                    if parts[:3] != ["apis", "visibility", "v1beta1"]:
                        raise KeyError(self.path)
                    rest = parts[3:]
                    if rest == ["clusterqueues"]:
                        body = service.cluster_queues_summary()
                    elif (len(rest) == 3 and rest[0] == "clusterqueues"
                          and rest[2] == "pendingworkloads"):
                        body = asdict(service.pending_workloads_cq(rest[1]))
                    elif (len(rest) == 5 and rest[0] == "namespaces"
                          and rest[2] == "localqueues"
                          and rest[4] == "pendingworkloads"):
                        body = asdict(
                            service.pending_workloads_lq(rest[1], rest[3]))
                    else:
                        raise KeyError(self.path)
                except (KeyError, IndexError):
                    self.send_response(404)
                    self.end_headers()
                    return
                payload = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self._httpd = DrainingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self, graceful: bool = True) -> None:
        if self._httpd is not None:
            if graceful:
                # finish in-flight submits before the socket closes
                self._httpd.drain(timeout=5.0)
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
