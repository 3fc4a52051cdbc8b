"""Remote-cluster transport for MultiKueue (reference
pkg/controller/admissionchecks/multikueue/multikueuecluster.go).

The reference talks to worker clusters through kubeconfig REST clients
with watch re-establishment and exponential retry.  The equivalent here
is a small HTTP API served by each worker process next to its admission
daemon (``cli serve --listen PORT``), and a manager-side client that
marks the cluster lost on connection errors:

    GET    /healthz
    GET    /apis/workloads                       → {"keys": [...]}
    GET    /apis/workloads/<ns>/<name>           → workload manifest
    POST   /apis/workloads                       → create from manifest
    DELETE /apis/workloads/<ns>/<name>
    POST   /apis/workloads/<ns>/<name>/finish    → fake execution hook
           (the perf-runner's condition flip; real jobs finish via the
           worker's own jobframework)

``LocalWorkerClient`` wraps an in-process Driver with the same surface
(the multi-envtest-in-one-process pattern, SURVEY §4.3), so the
MultiKueue controller is transport-agnostic.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .api import manifests as m
from .api.types import Workload
from .chaos import injector as _chaos


class ConnectionLost(Exception):
    """A transport failure: the cluster should be marked lost.

    ``kind`` classifies the failure for the retry policy over real
    sockets:

    - ``refused``: connect() was rejected — nothing reached the worker,
      so the request is trivially safe to retry (the worker is
      restarting behind its supervisor);
    - ``mid_body``: the connection died after the request went out
      (reset, broken pipe, truncated response) — the worker may have
      applied a mutation before the reply was lost, so a mutating retry
      first probes the watch epoch for a restart;
    - ``timeout`` / ``http`` / ``transport``: the undifferentiated rest.
    """

    def __init__(self, msg: str, kind: str = "transport"):
        super().__init__(msg)
        self.kind = kind


def state_digest(driver) -> str:
    """Digest of every workload's full durable status (timestamps
    included), shared by both ends of the distributed parity checks: a
    worker process answers ``/admin/digest`` with it and the
    single-process control computes it locally, so bit-identical state
    compares as equal strings with no JSON round-trip in between."""
    import hashlib
    from .federation.sim import full_state
    blob = repr(sorted(full_state(driver).items())).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


class LocalWorkerClient:
    """In-process worker (a Driver in the same process).

    ``ok`` is the fault-injection switch for tests and the federation
    sim: False severs the cluster — health probes fail and every API
    call raises ConnectionLost (a partitioned worker is unreachable for
    mutations too, not just watches — the multi-envtest pattern's
    killed transport)."""

    def __init__(self, driver):
        self.driver = driver
        self.ok = True

    def _check(self, what: str) -> None:
        if not self.ok:
            raise ConnectionLost(f"{what}: worker unreachable")

    def healthy(self) -> bool:
        return self.ok

    def create_workload(self, wl: Workload) -> None:
        self._check("create")
        if wl.key not in self.driver.workloads:
            self.driver.create_workload(wl)

    def get_workload(self, key: str) -> Optional[Workload]:
        self._check("get")
        return self.driver.workloads.get(key)

    def delete_workload(self, key: str) -> None:
        self._check("delete")
        self.driver.delete_workload(key)

    def list_workload_keys(self) -> list[str]:
        self._check("list")
        return list(self.driver.workloads)

    def list_workloads(self) -> dict[str, bool]:
        self._check("list")
        return {k: wl.is_finished
                for k, wl in list(self.driver.workloads.items())}

    def finish_workload(self, key: str, message: str = "finished") -> None:
        self._check("finish")
        self.driver.finish_workload(key, message)

    def watch_events(self, since: int, timeout: float = 0.0):
        """In-process watch: read the driver's append-only event log
        from the resume token (no blocking — the caller polls)."""
        if not self.ok:
            raise ConnectionLost("watch: worker down")
        events = self.driver.events
        batch = [tuple(e) for e in events[since:]]
        return batch, since + len(batch), str(id(self.driver))


class ChaosWorkerClient:
    """Transport fault injection for MultiKueue sync (chaos sites
    ``remote.delay`` / ``remote.duplicate`` / ``remote.partition``),
    wrapping any worker client with the same surface.

    Faults model the reference's unreliable kubeconfig transport:

    - *delay*: the call sleeps ``payload`` seconds first (a slow link);
    - *duplicate*: a mutation is issued twice (an at-least-once retry
      crossing a success) — workers absorb replays because ``create``
      is keyed and ``delete``/``finish`` are idempotent;
    - *partition*: the next ``times`` calls raise ConnectionLost; this
      wrapper heals them with capped exponential-backoff retry
      (multikueuecluster.go:67 retryAfter), so a partition shorter than
      the retry budget is invisible to the controller and a longer one
      surfaces as the usual mark-lost flow.
    """

    #: remote methods that mutate worker state (duplication targets)
    _MUTATORS = ("create_workload", "delete_workload", "finish_workload")

    def __init__(self, inner, injector=None, max_retries: int = 5,
                 backoff_base: float = 0.01, backoff_max: float = 0.5):
        self.inner = inner
        self.injector = injector
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.stats = {"calls": 0, "delays": 0, "duplicates": 0,
                      "partitioned": 0, "retries": 0}

    def _inj(self):
        return self.injector if self.injector is not None else _chaos.ACTIVE

    def _call(self, name: str, *args, **kw):
        import time as _time
        inner_fn = getattr(self.inner, name)
        inj = self._inj()
        self.stats["calls"] += 1
        if inj is None:
            return inner_fn(*args, **kw)
        backoff = self.backoff_base
        last_err = None
        for _ in range(self.max_retries + 1):
            if inj.hit("remote.partition") is not None:
                self.stats["partitioned"] += 1
                self.stats["retries"] += 1
                last_err = ConnectionLost(f"{name}: injected partition")
                _time.sleep(backoff)
                backoff = min(backoff * 2.0, self.backoff_max)
                continue
            f = inj.hit("remote.delay")
            if f is not None:
                self.stats["delays"] += 1
                _time.sleep(float(f.payload or 0.01))
            out = inner_fn(*args, **kw)
            if (name in self._MUTATORS
                    and inj.hit("remote.duplicate") is not None):
                self.stats["duplicates"] += 1
                inner_fn(*args, **kw)
            return out
        raise last_err or ConnectionLost(f"{name}: retries exhausted")

    def healthy(self) -> bool:
        try:
            return bool(self._call("healthy"))
        except ConnectionLost:
            return False

    def create_workload(self, wl: Workload) -> None:
        self._call("create_workload", wl)

    def get_workload(self, key: str) -> Optional[Workload]:
        return self._call("get_workload", key)

    def delete_workload(self, key: str) -> None:
        self._call("delete_workload", key)

    def list_workload_keys(self) -> list[str]:
        return self._call("list_workload_keys")

    def list_workloads(self) -> dict[str, bool]:
        return self._call("list_workloads")

    def finish_workload(self, key: str, message: str = "finished") -> None:
        self._call("finish_workload", key, message)

    def watch_events(self, since: int, timeout: float = 0.0):
        # no retry loop here: the WatchLoop owns watch backoff and its
        # lost/reconnected markers must see the raw failure
        inj = self._inj()
        if inj is not None and inj.hit("remote.partition") is not None:
            self.stats["partitioned"] += 1
            raise ConnectionLost("watch: injected partition")
        return self.inner.watch_events(since, timeout=timeout)


class WatchLoop:
    """Manager-side per-cluster watch thread (reference
    multikueuecluster.go:187-226 watch re-establishment).

    Long-polls the worker's event stream and pushes (kind, key, note)
    tuples into a thread-safe queue the controller drains on reconcile;
    connection loss pushes a ``("__lost__", ...)`` marker, then the loop
    keeps retrying with exponential backoff and pushes
    ``("__reconnected__", ...)`` when the stream is back — resuming from
    the last seen token, so every missed event is replayed.

    ``pump()`` is one poll-and-push step: the watch thread calls it in
    a loop, and deterministic harnesses (the federation sim, the
    delivery-order tests) call it directly with no thread in play so
    event delivery happens at controlled points."""

    def __init__(self, client, poll_timeout: float = 10.0):
        import queue as _queue
        self.client = client
        self.poll_timeout = poll_timeout
        self.events: "_queue.Queue" = _queue.Queue()
        self.since = 0
        self._epoch = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._was_lost = False
        self._backoff = 0.2

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop.is_set():
            self.pump(wait=self._stop.wait)

    def pump(self, wait=None) -> int:
        """One poll-and-push iteration; returns the number of workload
        events pushed.  ``wait`` is the pacing/backoff sleep — the watch
        thread passes its stop-aware wait, direct callers leave it None
        (no sleeping, the harness owns time)."""
        if wait is None:
            wait = lambda _s: None
        try:
            batch, nxt, epoch = self._poll()
        except Exception as e:
            # ANY failure is a connection loss (a dead watch thread
            # would silently stop all sync for the cluster)
            if not self._was_lost:
                self._was_lost = True
                self.events.put(("__lost__", "", str(e)))
            wait(self._backoff)
            self._backoff = min(self._backoff * 2.0, 30.0)
            return 0
        if (epoch is not None and self._epoch is not None
                and epoch != self._epoch):
            # the worker restarted with a fresh event log: the resume
            # token is meaningless — replay from 0 and tell the
            # controller to resync this cluster's assignments
            self._epoch = epoch
            self.since = 0
            self.events.put(("__resync__", "", ""))
            return 0
        if epoch is not None:
            self._epoch = epoch
        if self._was_lost:
            self._was_lost = False
            self.events.put(("__reconnected__", "", ""))
        self._backoff = 0.2
        inj = _chaos.ACTIVE
        if (inj is not None and batch
                and inj.hit("remote.duplicate_event") is not None):
            # at-least-once delivery: push the batch but do NOT advance
            # the resume token, so the next poll re-delivers all of it
            # (plus anything newer) — the controller's sync must absorb
            # the replay
            pass
        else:
            self.since = nxt
        for ev in batch:
            self.events.put(tuple(ev))
        if not batch:
            # blocking clients already waited out the long poll; the
            # in-process client returns instantly — pace either way
            wait(0.05)
        return len(batch)

    def _poll(self):
        out = self.client.watch_events(self.since,
                                       timeout=self.poll_timeout)
        if len(out) == 3:
            return out
        batch, nxt = out
        return batch, nxt, None


class HttpWorkerClient:
    """Manager-side remote client (multikueuecluster.go remoteClient).

    Transient transport failures are retried in place with jittered
    exponential backoff under a total-deadline budget: each request
    gets up to ``retries`` re-attempts, the i-th backoff is
    ``backoff_base·2^i`` stretched by a deterministic per-(path,
    attempt) jitter (0.5×–1.5×, crc32 not random so retry storms
    replay identically under test), and the whole request — attempts
    plus sleeps — must fit inside ``deadline_s``.  Retrying mutations
    is safe because the worker API is idempotent: create is keyed,
    delete/finish are no-ops when already applied.  Only once the
    budget is spent does ConnectionLost surface; the MultiKueue
    controller then marks the cluster inactive and retries with its
    own exponential backoff (multikueuecluster.go:67 retryAfter).
    Watch polls are never retried here — the WatchLoop owns watch
    backoff and must see the raw failure.

    ``KUEUE_TPU_REMOTE_RETRIES`` / ``KUEUE_TPU_REMOTE_DEADLINE_S``
    override the defaults (see ``features.ENV_FLAGS``)."""

    def __init__(self, base_url: str, timeout: float = 5.0,
                 retries: Optional[int] = None,
                 backoff_base: float = 0.05, backoff_max: float = 1.0,
                 deadline_s: Optional[float] = None):
        from .features import env_int
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.retries = (env_int("KUEUE_TPU_REMOTE_RETRIES")
                        if retries is None else retries)
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.deadline_s = (float(env_int("KUEUE_TPU_REMOTE_DEADLINE_S"))
                           if deadline_s is None else deadline_s)
        self.stats = {"requests": 0, "retries": 0, "deadline_exhausted": 0,
                      "refused_retries": 0, "midbody_retries": 0,
                      "epoch_resyncs": 0}
        # last watch epoch seen (from /healthz or the watch stream);
        # the mid-body retry path probes against it to detect a worker
        # restart hiding behind a half-delivered response
        self._epoch: Optional[str] = None

    def _note_epoch(self, epoch) -> None:
        if not epoch:
            return
        if self._epoch is not None and epoch != self._epoch:
            self.stats["epoch_resyncs"] += 1
        self._epoch = epoch

    def _probe_epoch(self):
        """One unretried health probe for the current watch epoch;
        None when the worker is (still) unreachable."""
        try:
            out = self._request_once("GET", "/healthz")
        except ConnectionLost:
            return None
        return (out or {}).get("epoch")

    @staticmethod
    def _jitter(path: str, attempt: int) -> float:
        import zlib
        return (zlib.crc32(f"{path}#{attempt}".encode()) % 1000) / 1000.0

    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 timeout_override: Optional[float] = None,
                 retries: Optional[int] = None, mutating: bool = False):
        import time as _time
        budget = self.retries if retries is None else retries
        deadline = _time.monotonic() + self.deadline_s
        attempt = 0
        while True:
            try:
                return self._request_once(method, path, body,
                                          timeout_override)
            except ConnectionLost as e:
                if attempt >= budget:
                    raise
                backoff = min(self.backoff_base * (2 ** attempt),
                              self.backoff_max)
                backoff *= 0.5 + self._jitter(path, attempt)
                if _time.monotonic() + backoff >= deadline:
                    self.stats["deadline_exhausted"] += 1
                    raise
                self.stats["retries"] += 1
                if e.kind == "refused":
                    # nothing reached the worker: a plain retry within
                    # the deadline rides out a restarting process
                    self.stats["refused_retries"] += 1
                elif e.kind == "mid_body":
                    self.stats["midbody_retries"] += 1
                    if mutating:
                        # the worker may have applied the mutation and
                        # died before answering; if it restarted, the
                        # epoch moved — noting it here bumps the resync
                        # counter so the watch replays from zero.  The
                        # retry itself stays safe either way: the worker
                        # API is idempotent (create keyed, delete/finish
                        # no-ops when already applied)
                        self._note_epoch(self._probe_epoch())
                _time.sleep(backoff)
                attempt += 1

    def _request_once(self, method: str, path: str,
                      body: Optional[dict] = None,
                      timeout_override: Optional[float] = None):
        import urllib.error
        import urllib.request
        self.stats["requests"] += 1
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout_override or self.timeout) as resp:
                payload = resp.read()
                return json.loads(payload) if payload else None
        except urllib.error.HTTPError as e:
            if e.code < 500:
                # application-level error (404 missing, 400 bad
                # manifest): the cluster itself is healthy — don't flap
                # it lost (multikueuecluster.go only reconnects on
                # transport failures)
                return None
            raise ConnectionLost(f"{method} {path}: HTTP {e.code}",
                                 kind="http") from e
        except ConnectionRefusedError as e:
            raise ConnectionLost(f"{method} {path}: {e}",
                                 kind="refused") from e
        except (ConnectionResetError, BrokenPipeError) as e:
            raise ConnectionLost(f"{method} {path}: {e}",
                                 kind="mid_body") from e
        except OSError as e:
            # urllib wraps connect-phase failures in URLError(reason);
            # unwrap so refused-vs-reset keeps its meaning there too
            import socket
            reason = getattr(e, "reason", None)
            if isinstance(reason, ConnectionRefusedError):
                kind = "refused"
            elif isinstance(reason, (ConnectionResetError,
                                     BrokenPipeError)):
                kind = "mid_body"
            elif isinstance(e, socket.timeout) or isinstance(
                    reason, socket.timeout):
                kind = "timeout"
            else:
                kind = "transport"
            raise ConnectionLost(f"{method} {path}: {e}", kind=kind) from e
        except Exception as e:
            # http.client.IncompleteRead/BadStatusLine etc.: a worker
            # dying mid-response is a transport failure, not a crash —
            # and since the request went out, a possible partial apply
            import http.client
            if isinstance(e, http.client.HTTPException):
                raise ConnectionLost(f"{method} {path}: {e}",
                                     kind="mid_body") from e
            raise

    def healthy(self) -> bool:
        # no retries: this is the half-open probe — the controller's
        # reconnect backoff owns the retry cadence
        try:
            out = self._request("GET", "/healthz", retries=0)
        except ConnectionLost:
            return False
        if isinstance(out, dict):
            self._note_epoch(out.get("epoch"))
        return out is not None

    def create_workload(self, wl: Workload) -> None:
        self._request("POST", "/apis/workloads", m.to_manifest(wl),
                      mutating=True)

    def get_workload(self, key: str) -> Optional[Workload]:
        ns, _, name = key.partition("/")
        doc = self._request("GET", f"/apis/workloads/{ns}/{name}")
        return m.from_manifest(doc) if doc else None

    def delete_workload(self, key: str) -> None:
        ns, _, name = key.partition("/")
        self._request("DELETE", f"/apis/workloads/{ns}/{name}",
                      mutating=True)

    def list_workload_keys(self) -> list[str]:
        out = self._request("GET", "/apis/workloads")
        return list(out.get("keys", [])) if out else []

    def list_workloads(self) -> dict[str, bool]:
        """{key: is_finished} in ONE round trip (GC reads this)."""
        out = self._request("GET", "/apis/workloads")
        if not out:
            return {}
        if "finished" in out:
            return {k: bool(v) for k, v in out["finished"].items()}
        return {k: False for k in out.get("keys", [])}

    def finish_workload(self, key: str, message: str = "finished") -> None:
        """Test/executor hook: flip the remote workload finished."""
        ns, _, name = key.partition("/")
        self._request("POST", f"/apis/workloads/{ns}/{name}/finish",
                      {"message": message}, mutating=True)

    # -- lockstep-harness admin endpoints (WorkerServer admin=True) --

    def set_clock(self, t: float) -> None:
        """Pin the worker's virtual clock (idempotent: same t, same
        result — safe under the mutating retry path)."""
        self._request("POST", "/admin/clock", {"t": t}, mutating=True)

    def admin_step(self) -> Optional[dict]:
        """One scheduling cycle on the worker.  Safe to retry within a
        lockstep barrier: re-running with unchanged state admits
        nothing further."""
        return self._request("POST", "/admin/step", {}, mutating=True)

    def admin_status(self) -> dict:
        out = self._request("GET", "/admin/status") or {}
        return out.get("status", {})

    def admin_digest(self) -> Optional[str]:
        out = self._request("GET", "/admin/digest") or {}
        return out.get("digest")

    def watch_events(self, since: int, timeout: float = 20.0):
        """Long-poll the worker's event stream from resume token
        ``since``.  Returns (events, next_token); blocks worker-side
        until events exist or the poll times out."""
        out = self._request(
            "GET", f"/apis/watch?since={since}&timeout={timeout}",
            timeout_override=timeout + self.timeout, retries=0)
        if out is None:
            return [], since, None
        self._note_epoch(out.get("epoch"))
        return ([tuple(e) for e in out.get("events", [])],
                int(out.get("next", since)), out.get("epoch"))


class DrainingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer hardened for restart-under-test.

    - ``allow_reuse_address``: a supervisor restarting a killed child
      on the *same* bound port must not trip TIME_WAIT, so client
      base_urls survive the restart (bound-port handoff);
    - in-flight handler census: ``finish_request`` is bracketed by a
      counter so :meth:`drain` can wait for handlers already running to
      complete before the listening socket closes — graceful shutdown
      finishes in-flight work instead of resetting it;
    - ``draining`` flips the ``/readyz`` probe to 503 (and breaks the
      watch long-poll) so pollers stop routing new work mid-drain.
    """

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()
        self.draining = False

    def finish_request(self, request, client_address):
        with self._inflight_lock:
            self._inflight += 1
            self._idle.clear()
        try:
            super().finish_request(request, client_address)
        finally:
            with self._inflight_lock:
                self._inflight -= 1
                if self._inflight == 0:
                    self._idle.set()

    def drain(self, timeout: float = 5.0) -> bool:
        """Stop advertising readiness and wait for in-flight handlers;
        True when the server went idle inside the timeout."""
        self.draining = True
        return self._idle.wait(timeout)


class _Handler(BaseHTTPRequestHandler):
    driver = None  # bound by WorkerServer

    def log_message(self, *args):  # quiet
        pass

    def _send(self, code: int, payload=None) -> None:
        body = b"" if payload is None else json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _wl_key(self) -> Optional[str]:
        parts = self.path.strip("/").split("/")
        # apis/workloads/<ns>/<name>[/finish]
        if len(parts) >= 4 and parts[0] == "apis" and parts[1] == "workloads":
            return f"{parts[2]}/{parts[3]}"
        return None

    def do_GET(self):
        if self.path == "/healthz":
            # liveness + the watch epoch, so one probe tells a client
            # both "alive" and "did it restart since I last looked"
            self._send(200, {
                "ok": True,
                "epoch": getattr(self.server, "epoch", None),
                "ready": not getattr(self.server, "draining", False)})
            return
        if self.path == "/readyz":
            # readiness: the supervisor polls this instead of sleeping
            if getattr(self.server, "draining", False):
                self._send(503, {"ready": False})
            else:
                self._send(200, {"ready": True})
            return
        if self.path.startswith("/admin/"):
            self._admin_get()
            return
        if self.path.startswith("/apis/watch"):
            # long-poll watch stream (reference multikueuecluster.go:187
            # per-cluster watch channels): the driver's append-only event
            # log is the resume token space — ?since=N returns events[N:]
            # as soon as any exist (or an empty batch on timeout), so a
            # reconnecting manager replays everything it missed
            from urllib.parse import parse_qs, urlparse
            q = parse_qs(urlparse(self.path).query)
            since = int(q.get("since", ["0"])[0])
            timeout = min(30.0, float(q.get("timeout", ["20"])[0]))
            import time as _time
            deadline = _time.monotonic() + timeout
            events = self.driver.events
            while (len(events) <= since and _time.monotonic() < deadline
                   and not getattr(self.server, "draining", False)):
                _time.sleep(0.02)
            batch = [list(e) for e in events[since:]]
            self._send(200, {"events": batch,
                             "next": since + len(batch),
                             "epoch": self.server.epoch})
            return
        if self.path.rstrip("/") == "/apis/workloads":
            items = list(self.driver.workloads.items())
            self._send(200, {"keys": [k for k, _ in items],
                             "finished": {k: wl.is_finished
                                          for k, wl in items}})
            return
        key = self._wl_key()
        if key is not None:
            wl = self.driver.workloads.get(key)
            if wl is None:
                self._send(404)
            else:
                self._send(200, m.to_manifest(wl))
            return
        self._send(404)

    def _admin_get(self):
        """Lockstep-harness read endpoints (``admin=True`` servers only):
        the distributed soak's parent process reads worker state through
        these instead of reaching into another process's memory."""
        if not getattr(self.server, "admin", False):
            self._send(404)
            return
        if self.path == "/admin/status":
            self._send(200, {"status": {
                k: [wl.has_quota_reservation, wl.is_finished]
                for k, wl in list(self.driver.workloads.items())}})
            return
        if self.path == "/admin/digest":
            self._send(200, {"digest": state_digest(self.driver),
                             "n": len(self.driver.workloads)})
            return
        self._send(404)

    def _admin_post(self, body):
        """Lockstep-harness mutation endpoints: the parent advances a
        child's virtual clock and runs its admission cycles at step
        barriers, which is what keeps N processes bit-deterministic."""
        if not getattr(self.server, "admin", False):
            self._send(404)
            return
        if self.path == "/admin/step":
            with self.server.step_lock:
                stats = self.driver.schedule_once()
            self._send(200, {"admitted": sorted(stats.admitted)})
            return
        if self.path == "/admin/clock":
            clk = getattr(self.server, "clock", None)
            if clk is None:
                self._send(404)
                return
            with self.server.step_lock:
                clk.t = float(body["t"])
            self._send(200, {"t": clk.t})
            return
        self._send(404)

    def do_POST(self):
        length = int(self.headers.get("Content-Length") or 0)
        body = json.loads(self.rfile.read(length)) if length else {}
        if self.path.startswith("/admin/"):
            self._admin_post(body)
            return
        if self.path.endswith("/finish"):
            key = self._wl_key()
            if key is None or key not in self.driver.workloads:
                self._send(404)
                return
            self.driver.finish_workload(
                key, body.get("message", "finished"))
            self._send(200, {"ok": True})
            return
        if self.path.rstrip("/") == "/apis/workloads":
            try:
                wl = m.from_manifest(body)
            except Exception:
                self._send(400)
                return
            if wl.key not in self.driver.workloads:
                self.driver.create_workload(wl)
                jr = getattr(self.server, "journal", None)
                if jr is not None:
                    # manifest durable before the ack: a SIGKILLed
                    # worker rebuilds its initial payloads from here
                    jr.put(wl.key, body)
            self._send(201, {"ok": True})
            return
        self._send(404)

    def do_DELETE(self):
        key = self._wl_key()
        if key is None:
            self._send(404)
            return
        self.driver.delete_workload(key)
        jr = getattr(self.server, "journal", None)
        if jr is not None:
            jr.delete(key)
        self._send(200, {"ok": True})


class WorkerServer:
    """The worker-side HTTP API, served next to the admission daemon.

    ``journal`` (a ``ManifestJournal``) makes creates/deletes durable
    before their ack.  ``admin=True`` exposes the lockstep harness
    endpoints (``/admin/step``, ``/admin/clock``, ``/admin/status``,
    ``/admin/digest``) the distributed soak drives child processes
    with; ``clock`` is the mutable virtual clock ``/admin/clock``
    sets.  ``epoch`` pins the watch-log epoch (tests); by default a
    restarted process serves a fresh one, which is what tells managers
    their resume tokens died with the old process."""

    def __init__(self, driver, port: int = 0, host: str = "127.0.0.1",
                 journal=None, admin: bool = False, clock=None,
                 epoch: Optional[str] = None):
        import uuid
        handler = type("BoundHandler", (_Handler,), {"driver": driver})
        self.httpd = DrainingHTTPServer((host, port), handler)
        # watch-log epoch: a restarted worker process serves a fresh
        # (shorter) event log, so resume tokens from the old epoch must
        # trigger a replay-from-zero + resync instead of silent skips
        self.httpd.epoch = epoch or uuid.uuid4().hex
        self.httpd.journal = journal
        self.httpd.admin = admin
        self.httpd.clock = clock
        self.httpd.step_lock = threading.Lock()
        self.driver = driver
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self, graceful: bool = True) -> None:
        if graceful:
            # finish in-flight handlers before the socket closes; the
            # draining flag also breaks pending watch long-polls
            self.httpd.drain(timeout=5.0)
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
