"""Socket-fault proxy: transport chaos injected at the wire.

``SocketFaultProxy`` is a listen-and-forward TCP proxy placed between
an ``HttpWorkerClient`` (or any HTTP caller) and a real server
process.  Each accepted connection consults the fault schedule and
either forwards cleanly or injects one of four wire-level faults —
the failure modes a mock transport can't produce honestly:

- ``reset``: close the client socket with SO_LINGER=0 (a hard RST),
  before anything reaches upstream — the client sees
  ``ConnectionResetError`` mid-request;
- ``latency``: sleep ``payload`` seconds before dialing upstream (a
  slow link; drives the client's timeout/deadline budget);
- ``truncate``: forward the request, then relay only the first
  ``payload`` bytes of the response and RST — the client sees a
  half-delivered body (``IncompleteRead``/``BadStatusLine``), the
  mid-body retry path's home turf;
- ``blackhole``: accept, read, and never answer — the client's socket
  timeout is the only way out.

Faults come from two seeded sources, chaos-site first: an armed
``dist.proxy_fault`` fault fires by deterministic hit count (its
``action`` picks the verb, its ``payload`` the seconds/bytes), and an
optional :class:`FaultPlan` of per-connection probabilities (the
``KUEUE_TPU_DIST_PROXY_*`` flags) drives longer soaks through the
proxy's own ``random.Random(seed)`` — reproducible either way.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..chaos import injector as _chaos
from ..features import env_int, env_value

#: default fault magnitudes when an armed fault carries no payload
_DEFAULT_LATENCY_S = 0.2
_DEFAULT_TRUNCATE_BYTES = 24


@dataclass(frozen=True)
class FaultPlan:
    """Per-connection fault probabilities (all default 0 = clean)."""
    reset: float = 0.0
    latency: float = 0.0
    truncate: float = 0.0
    blackhole: float = 0.0
    latency_s: float = _DEFAULT_LATENCY_S

    @classmethod
    def resolved(cls, **overrides) -> "FaultPlan":
        """Build from the ``KUEUE_TPU_DIST_PROXY_*`` flags, with
        keyword overrides taking precedence."""
        def flag(name):
            try:
                return float(env_value(name) or 0.0)
            except ValueError:
                return 0.0
        vals = {"reset": flag("KUEUE_TPU_DIST_PROXY_RESET"),
                "latency": flag("KUEUE_TPU_DIST_PROXY_LATENCY_S") and 1.0,
                "latency_s": flag("KUEUE_TPU_DIST_PROXY_LATENCY_S")
                or _DEFAULT_LATENCY_S,
                "truncate": flag("KUEUE_TPU_DIST_PROXY_TRUNCATE"),
                "blackhole": flag("KUEUE_TPU_DIST_PROXY_BLACKHOLE")}
        vals.update(overrides)
        return cls(**vals)

    @property
    def any(self) -> bool:
        return bool(self.reset or self.latency or self.truncate
                    or self.blackhole)


def _rst_close(sock: socket.socket) -> None:
    """Close with SO_LINGER=0: the peer gets a hard RST, not FIN."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class SocketFaultProxy:
    """Seeded listen-and-forward proxy in front of one upstream port."""

    def __init__(self, upstream_port: int, host: str = "127.0.0.1",
                 port: int = 0, plan: Optional[FaultPlan] = None,
                 seed: Optional[int] = None):
        import random
        self.upstream = (host, upstream_port)
        self.plan = plan or FaultPlan()
        self.rng = random.Random(
            env_int("KUEUE_TPU_DIST_SEED") if seed is None else seed)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.port = self._listener.getsockname()[1]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._conns: list[socket.socket] = []
        self._lock = threading.Lock()
        self.stats = {"connections": 0, "forwarded": 0, "resets": 0,
                      "latencies": 0, "truncations": 0, "blackholes": 0,
                      "bytes_up": 0, "bytes_down": 0}

    @property
    def base_url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    # -- fault schedule --

    def _decide(self) -> tuple[Optional[str], float]:
        """(fault verb, magnitude) for the next connection — the armed
        chaos site wins over the probability plan."""
        inj = _chaos.ACTIVE
        if inj is not None:
            f = inj.hit("dist.proxy_fault")
            if f is not None and f.action in ("reset", "latency",
                                              "truncate", "blackhole"):
                return f.action, float(f.payload or 0.0)
        p = self.plan
        if p.any:
            roll = self.rng.random()
            for verb, prob, mag in (("reset", p.reset, 0.0),
                                    ("latency", p.latency, p.latency_s),
                                    ("truncate", p.truncate,
                                     _DEFAULT_TRUNCATE_BYTES),
                                    ("blackhole", p.blackhole, 0.0)):
                if prob <= 0.0:
                    continue
                if roll < prob:
                    return verb, mag
                roll -= prob
        return None, 0.0

    # -- lifecycle --

    def start(self) -> None:
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _ = self._listener.accept()
            except OSError:
                return
            self.stats["connections"] += 1
            threading.Thread(target=self._handle, args=(client,),
                             daemon=True).start()

    # -- per-connection forwarding --

    def _handle(self, client: socket.socket) -> None:
        verb, mag = self._decide()
        if verb == "reset":
            self.stats["resets"] += 1
            _rst_close(client)
            return
        if verb == "blackhole":
            self.stats["blackholes"] += 1
            self._blackhole(client)
            return
        if verb == "latency":
            self.stats["latencies"] += 1
            time.sleep(mag or _DEFAULT_LATENCY_S)
        limit = None
        if verb == "truncate":
            self.stats["truncations"] += 1
            limit = int(mag) or _DEFAULT_TRUNCATE_BYTES
        try:
            up = socket.create_connection(self.upstream, timeout=10.0)
        except OSError:
            # upstream itself is down (e.g. mid-restart): behave like
            # the wire — refuse by RST
            _rst_close(client)
            return
        with self._lock:
            self._conns += [client, up]
        self.stats["forwarded"] += 1
        t_up = threading.Thread(
            target=self._pump, args=(client, up, "bytes_up", None),
            daemon=True)
        t_up.start()
        self._pump(up, client, "bytes_down", limit)
        t_up.join(timeout=10.0)

    def _pump(self, src: socket.socket, dst: socket.socket,
              counter: str, limit: Optional[int]) -> None:
        """Copy bytes src→dst until EOF; with ``limit``, relay that
        many bytes then RST both ends (a truncated write)."""
        sent = 0
        try:
            while True:
                buf = src.recv(65536)
                if not buf:
                    break
                if limit is not None and sent + len(buf) >= limit:
                    dst.sendall(buf[:max(0, limit - sent)])
                    self.stats[counter] += max(0, limit - sent)
                    self._abort_pair(dst, src)
                    return
                dst.sendall(buf)
                sent += len(buf)
                self.stats[counter] += len(buf)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                if not self._lingering(s):
                    # graceful path: FIN both directions before close
                    try:
                        s.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                try:
                    s.close()
                except OSError:
                    pass

    @staticmethod
    def _lingering(s: socket.socket) -> bool:
        """True when :meth:`_abort_pair` armed linger-0 on this socket
        — the marker telling the pump's teardown to stay abortive."""
        try:
            onoff, _ = struct.unpack("ii", s.getsockopt(
                socket.SOL_SOCKET, socket.SO_LINGER, 8))
            return bool(onoff)
        except OSError:
            return False

    @staticmethod
    def _abort_pair(a: socket.socket, b: socket.socket) -> None:
        """Abortive teardown of a forwarding pair: the peer must see an
        RST, not a FIN — a truncated-then-FINed response can parse as a
        short-but-valid success.  A bare linger-0 close is not enough
        either: the opposite pump thread is blocked in ``recv`` on one
        of these sockets, which keeps the kernel file alive past
        ``close()`` and the RST in limbo forever.  So: arm linger-0
        (makes the *last* close abortive, and flags the peer pump's
        teardown via :meth:`_lingering` to skip its graceful FIN), wake
        the parked thread with a local-only ``SHUT_RD`` (no wire
        traffic), then drop our reference."""
        for s in (a, b):
            try:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                             struct.pack("ii", 1, 0))
            except OSError:
                pass
        for s in (a, b):
            try:
                s.shutdown(socket.SHUT_RD)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    def _blackhole(self, client: socket.socket) -> None:
        """Swallow the request and never answer; the client's socket
        timeout is the only exit."""
        client.settimeout(0.5)
        deadline = time.monotonic() + 30.0
        try:
            while not self._stop.is_set() and time.monotonic() < deadline:
                try:
                    if not client.recv(65536):
                        break
                except socket.timeout:
                    continue
                except OSError:
                    break
        finally:
            try:
                client.close()
            except OSError:
                pass
