"""Seeded process supervisor for the distributed control plane.

``ProcessSupervisor`` owns the child processes of a distributed run:
it spawns them (``python -m kueue_tpu_torch.dist.child``), waits for
readiness by polling the child's bound-port file and ``/readyz``
endpoint (never by sleeping a guessed interval), SIGKILLs them on a
deterministic schedule, and respawns them on the *same* bound port so
client base URLs survive the restart (``DrainingHTTPServer`` sets
SO_REUSEADDR for exactly this handoff).

Kills follow the chaos-injector site pattern: every barrier the
harness consults :meth:`maybe_kill`, which asks the installed injector
for a ``dist.kill`` fault whose payload names the target process.
Arming ``dist.kill`` with ``at=N`` therefore kills the named child at
the Nth consultation — the same deterministic replayable schedule the
in-process crash sites use, but delivered as a real SIGKILL.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Optional

from ..chaos import injector as _chaos
from ..features import env_int


@dataclass
class ManagedProcess:
    """One supervised child: its spawn recipe plus live state."""
    name: str
    role: str                       # shard | worker | submitter | service
    argv: list[str]
    env: dict[str, str]
    port_file: Optional[str] = None
    port: Optional[int] = None
    proc: Optional[subprocess.Popen] = None
    restarts: int = 0
    pipe_stdio: bool = False

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class ProcessSupervisor:
    """Spawn, monitor, kill, and respawn the run's child processes."""

    def __init__(self, seed: Optional[int] = None):
        self.seed = env_int("KUEUE_TPU_DIST_SEED") if seed is None else seed
        self.procs: dict[str, ManagedProcess] = {}
        self.stats: dict[str, dict[str, int]] = {}
        self.kill_log: list[str] = []

    def _bump(self, role: str, what: str) -> None:
        per = self.stats.setdefault(
            role, {"spawns": 0, "kills": 0, "restarts": 0})
        per[what] += 1

    # -- lifecycle --

    def spawn(self, name: str, role: str, argv: list[str],
              env: Optional[dict] = None, port_file: Optional[str] = None,
              pipe_stdio: bool = False) -> ManagedProcess:
        mp = self.procs.get(name)
        if mp is None:
            mp = ManagedProcess(name=name, role=role, argv=list(argv),
                                env=dict(env or os.environ),
                                port_file=port_file, pipe_stdio=pipe_stdio)
            self.procs[name] = mp
        else:
            mp.argv = list(argv)
            if env is not None:
                mp.env = dict(env)
        self._launch(mp)
        self._bump(role, "spawns")
        return mp

    def _launch(self, mp: ManagedProcess) -> None:
        pipe = subprocess.PIPE if mp.pipe_stdio else None
        mp.proc = subprocess.Popen(
            mp.argv, env=mp.env, stdin=pipe, stdout=pipe,
            stderr=subprocess.PIPE, text=True)

    def wait_port(self, mp: ManagedProcess, timeout: float = 30.0) -> int:
        """Poll the child's port file until the bound port lands there
        (the child writes it after bind, before serving)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if mp.port_file and os.path.exists(mp.port_file):
                try:
                    with open(mp.port_file) as f:
                        txt = f.read().strip()
                    if txt:
                        mp.port = int(txt)
                        return mp.port
                except (OSError, ValueError):
                    pass
            if not mp.alive:
                raise RuntimeError(
                    f"{mp.name} died before binding: "
                    f"{self._death_note(mp)}")
            time.sleep(0.02)
        raise TimeoutError(f"{mp.name}: no port after {timeout}s")

    def wait_ready(self, mp: ManagedProcess, timeout: float = 30.0) -> int:
        """Bound-port handoff + readiness: poll the port file, then the
        child's ``/readyz`` until it answers 200."""
        self.wait_port(mp, timeout=timeout)
        deadline = time.monotonic() + timeout
        url = f"http://127.0.0.1:{mp.port}/readyz"
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(url, timeout=1.0) as resp:
                    if resp.status == 200:
                        return mp.port
            except (urllib.error.URLError, OSError, ConnectionError):
                pass
            if not mp.alive:
                raise RuntimeError(
                    f"{mp.name} died before ready: {self._death_note(mp)}")
            time.sleep(0.02)
        raise TimeoutError(f"{mp.name}: not ready after {timeout}s")

    def _death_note(self, mp: ManagedProcess) -> str:
        if mp.proc is None:
            return "never spawned"
        err = ""
        try:
            if mp.proc.stderr is not None:
                err = mp.proc.stderr.read()[-2000:]
        except (OSError, ValueError):
            pass
        return f"exit={mp.proc.returncode} stderr={err!r}"

    # -- killing --

    def kill(self, name: str) -> bool:
        """SIGKILL the named child (no warning, no cleanup — the whole
        point).  True when a live process was actually killed."""
        mp = self.procs.get(name)
        if mp is None or not mp.alive:
            return False
        os.kill(mp.proc.pid, signal.SIGKILL)
        mp.proc.wait(timeout=10.0)
        self._bump(mp.role, "kills")
        self.kill_log.append(name)
        return True

    def maybe_kill(self, name: str) -> bool:
        """Consult the chaos schedule: a ``dist.kill`` fault whose
        payload names this process (or names nothing) SIGKILLs it.
        Call once per barrier per candidate — the injector's hit
        counter is the deterministic clock."""
        inj = _chaos.ACTIVE
        if inj is None:
            return False
        f = inj.hit("dist.kill")
        if f is None:
            return False
        if f.payload not in (None, "", name):
            return False
        return self.kill(name)

    def restart(self, name: str, argv: Optional[list] = None,
                timeout: float = 30.0) -> ManagedProcess:
        """Respawn a killed child.  Pass ``argv`` to pin the restart to
        the old bound port (``--port N`` instead of ``--port 0``); the
        port file is cleared first so ``wait_ready`` reads the fresh
        bind, whatever port it lands on."""
        mp = self.procs[name]
        if mp.alive:
            self.kill(name)
        if argv is not None:
            mp.argv = list(argv)
        if mp.port_file and os.path.exists(mp.port_file):
            os.unlink(mp.port_file)
        self._launch(mp)
        mp.restarts += 1
        self._bump(mp.role, "restarts")
        if mp.port_file:
            self.wait_ready(mp, timeout=timeout)
        return mp

    def terminate_all(self) -> None:
        for mp in self.procs.values():
            if mp.alive:
                try:
                    os.kill(mp.proc.pid, signal.SIGKILL)
                except OSError:
                    pass
        for mp in self.procs.values():
            if mp.proc is not None:
                try:
                    mp.proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    pass

    # -- reporting --

    def report(self) -> dict:
        return {
            "seed": self.seed,
            "procs": {n: {"role": mp.role, "port": mp.port,
                          "alive": mp.alive, "restarts": mp.restarts}
                      for n, mp in self.procs.items()},
            "by_role": {r: dict(s) for r, s in sorted(self.stats.items())},
            "kill_log": list(self.kill_log),
        }


def child_argv(role: str, **kw) -> list[str]:
    """argv for ``python -m kueue_tpu_torch.dist.child`` with ``--key
    value`` pairs (None values skipped, bools as 1/0); pass ``device``
    to choose the child's device (the child's own default is "cuda")."""
    argv = [sys.executable, "-m", "kueue_tpu_torch.dist.child",
            "--role", role]
    for key, val in kw.items():
        if val is None:
            continue
        if isinstance(val, bool):
            val = int(val)
        argv += [f"--{key.replace('_', '-')}", str(val)]
    return argv


def read_json(url: str, timeout: float = 5.0) -> Optional[dict]:
    """One unretried GET returning parsed JSON (supervisor probes)."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            payload = resp.read()
        return json.loads(payload) if payload else None
    except (urllib.error.URLError, OSError, ConnectionError,
            json.JSONDecodeError):
        return None
