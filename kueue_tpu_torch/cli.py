"""kueuectl-equivalent CLI (reference cmd/kueuectl, ~5.5k LoC of cobra).

Run as ``python -m kueue_tpu_torch.cli [--device cuda|cpu] ...``.
Commands mirror the kubectl-kueue plugin surface (app/cmd.go:59):
create/apply/delete, list, stop/resume, plus ``schedule`` (run admission
cycles), ``state`` (debugger dump), ``import`` (cmd/importer-equivalent
bulk import of running pods), ``serve`` (the admission daemon) and
``version``.

State model: a directory of manifests (JSON) is the API-server stand-in;
every command replays it into a Driver (the reference's cache/queue
rebuild from CRD watch replay — SURVEY §5.4), mutates, schedules if
asked, and writes status back.

Device: every Driver a command builds runs on ``--device`` (default
"cuda", where its cycles launch the CUDA kernels; "cpu" runs their
plain PyTorch versions) and decides cycles with the device solver, with
or without ``--device-solver``, which is accepted so that command lines
written for the reference run unchanged.  Without a GPU, ``--device
cuda`` raises as ``Driver()`` does: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .api import manifests as m
from .api.types import (
    AdmissionCheck,
    ClusterQueue,
    Cohort,
    LocalQueue,
    ResourceFlavor,
    ResourceQuota,
    FlavorQuotas,
    ResourceGroup,
    StopPolicy,
    Topology,
    Workload,
    WorkloadPriorityClass,
)
from .controller.driver import Driver
from .features import env_value

VERSION = "0.1.0 (kueue reference parity ≈ v0.11)"
STATE_FILE = "state.json"


# ---------------------------------------------------------------------------
# State store
# ---------------------------------------------------------------------------

class Store:
    def __init__(self, state_dir: str):
        self.state_dir = state_dir
        self.docs: list[dict] = []
        path = os.path.join(state_dir, STATE_FILE)
        if os.path.exists(path):
            with open(path) as f:
                self.docs = json.load(f)

    def save(self) -> None:
        os.makedirs(self.state_dir, exist_ok=True)
        path = os.path.join(self.state_dir, STATE_FILE)
        # write-then-rename: readers (the serve watcher) never see a
        # truncated/partial file
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.docs, f, indent=1)
        os.replace(tmp, path)

    # -- doc helpers ---------------------------------------------------

    @staticmethod
    def _ident(doc: dict) -> tuple:
        meta = doc.get("metadata") or {}
        return (doc.get("kind"), meta.get("namespace", "default"),
                meta.get("name"))

    def upsert(self, doc: dict) -> None:
        ident = self._ident(doc)
        self.docs = [d for d in self.docs if self._ident(d) != ident]
        self.docs.append(doc)

    def delete(self, kind: str, name: str, namespace: str = "default") -> bool:
        ident = (kind, namespace, name)
        before = len(self.docs)
        self.docs = [d for d in self.docs if self._ident(d) != ident]
        return len(self.docs) != before

    def by_kind(self, kind: str) -> list[dict]:
        return [d for d in self.docs if d.get("kind") == kind]

    def get(self, kind: str, name: str,
            namespace: str = "default") -> dict | None:
        for d in self.docs:
            if self._ident(d) == (kind, namespace, name):
                return d
        return None


def apply_spec(d: Driver, doc: dict) -> None:
    """Apply one non-Workload manifest to a driver."""
    kind = doc.get("kind")
    obj = m.from_manifest(doc)
    if kind == "ResourceFlavor":
        d.apply_resource_flavor(obj)
    elif kind == "Topology":
        d.apply_topology(obj)
    elif kind == "AdmissionCheck":
        d.apply_admission_check(obj)
    elif kind == "WorkloadPriorityClass":
        d.apply_workload_priority_class(obj)
    elif kind == "Cohort":
        d.apply_cohort(obj)
    elif kind == "ClusterQueue":
        d.apply_cluster_queue(obj)
    elif kind == "LocalQueue":
        d.apply_local_queue(obj)


def build_driver(store: Store, device: str = "cuda") -> Driver:
    """Replay the store into a fresh Driver on ``device`` (its cycles
    decided by the device solver)."""
    d = Driver(device=device)
    order = ["ResourceFlavor", "Topology", "AdmissionCheck",
             "WorkloadPriorityClass", "Cohort", "ClusterQueue", "LocalQueue"]
    for kind in order:
        for doc in store.by_kind(kind):
            apply_spec(d, doc)
    for doc in store.by_kind("Workload"):
        d.restore_workload(m.from_manifest(doc))
    return d


def save_workloads(store: Store, driver: Driver) -> None:
    for wl in driver.workloads.values():
        store.upsert(m.to_manifest(wl))
    live = {("Workload", wl.namespace, wl.name)
            for wl in driver.workloads.values()}
    store.docs = [d for d in store.docs
                  if d.get("kind") != "Workload"
                  or Store._ident(d) in live]


# ---------------------------------------------------------------------------
# Commands
# ---------------------------------------------------------------------------

def cmd_apply(store: Store, args) -> int:
    text = (sys.stdin.read() if args.filename == "-"
            else open(args.filename).read())
    objs = []
    import yaml
    for doc in yaml.safe_load_all(text):
        if not doc:
            continue
        obj = m.from_manifest(doc)   # validates the kind is supported
        objs.append((doc, obj))
    driver = build_driver(store, device=args.device)  # validates state
    for doc, obj in objs:
        # webhook-equivalent validation before persisting
        from . import webhooks
        if isinstance(obj, ClusterQueue):
            webhooks.validate_cluster_queue(obj)
        elif isinstance(obj, Workload):
            webhooks.default_workload(obj)
            webhooks.validate_workload(obj)
        elif isinstance(obj, LocalQueue):
            webhooks.validate_local_queue(obj)
        elif isinstance(obj, ResourceFlavor):
            webhooks.validate_resource_flavor(obj)
        elif isinstance(obj, Cohort):
            webhooks.validate_cohort(obj)
        store.upsert(doc)
        print(f"{doc['kind'].lower()}/{doc['metadata']['name']} applied")
    store.save()
    return 0


def _mk(kind: str, name: str, spec: dict, namespace: str | None = None) -> dict:
    meta: dict = {"name": name}
    if namespace:
        meta["namespace"] = namespace
    version = "v1alpha1" if kind in ("Cohort", "Topology") else "v1beta1"
    return {"apiVersion": f"kueue.x-k8s.io/{version}", "kind": kind,
            "metadata": meta, "spec": spec}


def cmd_create(store: Store, args) -> int:
    if args.resource == "clusterqueue":
        spec: dict = {"queueingStrategy": "BestEffortFIFO"}
        if args.cohort:
            spec["cohort"] = args.cohort
        groups = []
        if args.nominal_quota:
            resources = []
            for part in args.nominal_quota.split(","):
                rname, qty = part.split("=", 1)
                resources.append({"name": rname, "nominalQuota": qty})
            groups.append({
                "coveredResources": [r["name"] for r in resources],
                "flavors": [{"name": args.flavor or "default",
                             "resources": resources}]})
        spec["resourceGroups"] = groups
        doc = _mk("ClusterQueue", args.name, spec)
    elif args.resource == "localqueue":
        doc = _mk("LocalQueue", args.name,
                  {"clusterQueue": args.clusterqueue},
                  namespace=args.namespace)
    elif args.resource == "resourceflavor":
        labels = {}
        for part in (args.node_labels or "").split(","):
            if "=" in part:
                k, v = part.split("=", 1)
                labels[k] = v
        doc = _mk("ResourceFlavor", args.name, {"nodeLabels": labels})
    else:
        print(f"unknown resource {args.resource}", file=sys.stderr)
        return 1
    obj = m.from_manifest(doc)
    from . import webhooks
    if isinstance(obj, ClusterQueue):
        webhooks.validate_cluster_queue(obj)
    store.upsert(doc)
    store.save()
    print(f"{doc['kind'].lower()}/{args.name} created")
    return 0


def cmd_list(store: Store, args) -> int:
    kind_map = {"clusterqueue": "ClusterQueue", "cq": "ClusterQueue",
                "localqueue": "LocalQueue", "lq": "LocalQueue",
                "workload": "Workload", "wl": "Workload",
                "resourceflavor": "ResourceFlavor", "rf": "ResourceFlavor"}
    kind = kind_map.get(args.resource)
    if kind is None:
        print(f"unknown resource {args.resource}", file=sys.stderr)
        return 1
    driver = build_driver(store, device=args.device)
    if kind == "Workload":
        print(f"{'NAMESPACE':<12} {'NAME':<40} {'QUEUE':<16} "
              f"{'ADMITTED':<9} STATUS")
        for wl in driver.workloads.values():
            status = ("Finished" if wl.is_finished else
                      "Admitted" if wl.is_admitted else
                      "QuotaReserved" if wl.has_quota_reservation else
                      "Pending" if wl.is_active else "Inactive")
            print(f"{wl.namespace:<12} {wl.name:<40} {wl.queue_name:<16} "
                  f"{str(wl.is_admitted):<9} {status}")
    elif kind == "ClusterQueue":
        print(f"{'NAME':<24} {'COHORT':<12} {'PENDING':<8} USAGE")
        for name in driver.cache.cluster_queue_names():
            cq = driver.cache.cluster_queue(name)
            usage = {f"{fr.flavor}/{fr.resource}": v
                     for fr, v in sorted(driver.cache.usage(name).items())
                     if v}
            cohort = (store.get("ClusterQueue", name) or {}).get(
                "spec", {}).get("cohort") or ""
            print(f"{name:<24} {cohort:<12} "
                  f"{driver.queues.pending_workloads(name):<8} {usage}")
    else:
        for doc in store.by_kind(kind):
            print(f"{doc['kind'].lower()}/{doc['metadata']['name']}")
    return 0


def cmd_delete(store: Store, args) -> int:
    kind_map = {"clusterqueue": "ClusterQueue", "localqueue": "LocalQueue",
                "workload": "Workload", "resourceflavor": "ResourceFlavor",
                "cohort": "Cohort"}
    kind = kind_map.get(args.resource)
    if kind is None or not store.delete(kind, args.name,
                                        args.namespace or "default"):
        print(f"{args.resource}/{args.name} not found", file=sys.stderr)
        return 1
    store.save()
    print(f"{args.resource}/{args.name} deleted")
    return 0


def _set_stop_policy(store: Store, args, policy: StopPolicy) -> int:
    """stop/resume {workload,clusterqueue,localqueue} (kueuectl KEP 2076)."""
    if args.resource == "workload":
        doc = store.get("Workload", args.name, args.namespace or "default")
        if doc is None:
            print(f"workload/{args.name} not found", file=sys.stderr)
            return 1
        doc.setdefault("spec", {})["active"] = (policy == StopPolicy.NONE)
        driver = build_driver(store, device=args.device)
        if policy != StopPolicy.NONE:
            driver.deactivate_workload(f"{args.namespace or 'default'}/{args.name}")
        save_workloads(store, driver)
    else:
        kind = {"clusterqueue": "ClusterQueue",
                "localqueue": "LocalQueue"}.get(args.resource)
        if kind is None:
            print(f"unknown resource {args.resource}", file=sys.stderr)
            return 1
        doc = store.get(kind, args.name,
                        None if kind == "ClusterQueue"
                        else (args.namespace or "default"))
        if doc is None:
            doc = store.get(kind, args.name, "default")
        if doc is None:
            print(f"{args.resource}/{args.name} not found", file=sys.stderr)
            return 1
        doc.setdefault("spec", {})["stopPolicy"] = policy.value
    store.save()
    print(f"{args.resource}/{args.name} "
          + ("stopped" if policy != StopPolicy.NONE else "resumed"))
    return 0


def cmd_schedule(store: Store, args) -> int:
    from .profiling import trace
    driver = build_driver(store, device=args.device)
    with trace(getattr(args, "profile_dir", None)):
        driver.run_until_settled(max_cycles=args.cycles)
    save_workloads(store, driver)
    store.save()
    admitted = sorted(driver.admitted_keys())
    print(f"admitted {len(admitted)} workloads")
    for key in admitted:
        print(f"  {key}")
    return 0


def cmd_state(store: Store, args) -> int:
    from .debugger import dump_state
    print(dump_state(build_driver(store, device=args.device)))
    return 0


def cmd_serve(store: Store, args) -> int:
    """Daemon mode (reference cmd/kueue manager + scheduler Runnable):
    a long-running admission loop over blocking heads with speed-signal
    backoff, a store watcher that picks up `cli apply` edits from other
    processes, SIGUSR2 state dumps, and graceful SIGINT/SIGTERM
    shutdown with workload status persisted back to the store."""
    import signal as _signal
    import threading

    stop = threading.Event()

    # leader election: exactly one daemon per store (reference
    # config.go:97 leader election; the scheduler runs only when elected)
    from .leaderelection import FileLease
    lease = FileLease(args.state_dir)
    if not lease.try_acquire():
        print(f"waiting for leadership on {args.state_dir}", flush=True)
        if not lease.acquire(stop):
            return 0
    store = Store(args.state_dir)  # reload: the old leader wrote status
    try:
        driver = build_driver(store, device=args.device)
    except BaseException:
        lease.release()                # no device: leave the lease free
        raise

    from .debugger import Dumper
    dumper = Dumper(driver)
    try:
        dumper.listen_for_signal()          # SIGUSR2 → state dump
        for sig in (_signal.SIGINT, _signal.SIGTERM):
            _signal.signal(sig, lambda *_: stop.set())
    except ValueError:
        pass  # not on the main thread (tests drive serve threaded)

    store_path = os.path.join(store.state_dir, STATE_FILE)

    def store_stat():
        try:
            st = os.stat(store_path)
            return (st.st_mtime_ns, st.st_size)
        except OSError:
            return None

    seen_stat = store_stat()

    def watch_store():
        """Poll the store file; mirror spec changes made by other
        processes (the API-server watch equivalent).  New workloads are
        restored (admitted status charges the cache — cli import),
        removed ones are deleted.  Any torn read or bad manifest skips
        the poll; the watcher never dies."""
        nonlocal seen_stat
        while not stop.wait(args.poll_interval):
            try:
                st = store_stat()
                if st is None or st == seen_stat:
                    continue
                seen_stat = st
                fresh = Store(args.state_dir)
                store_keys = set()
                for doc in fresh.docs:
                    kind = doc.get("kind")
                    if kind == "Workload":
                        meta = doc.get("metadata") or {}
                        key = (f"{meta.get('namespace', 'default')}"
                               f"/{meta.get('name')}")
                        store_keys.add(key)
                        if driver.workload(key) is None:
                            driver.restore_workload(m.from_manifest(doc))
                    elif kind:
                        apply_spec(driver, doc)
                for key in list(driver.workloads):
                    if key not in store_keys:
                        driver.delete_workload(key)
                driver.queues.broadcast()
            except Exception as exc:       # torn read / bad manifest
                print(f"store watch: skipping poll: {exc}", flush=True)

    def drained() -> bool:
        """No workload can make progress: every active heap is empty
        (parked-inadmissible workloads wait on events, not cycles)."""
        return not any(driver.queues.pending_active_workloads(name)
                       for name in driver.queues.cluster_queue_names())

    watcher = threading.Thread(target=watch_store, daemon=True)
    watcher.start()
    if args.exit_when_drained:
        def drain_check():
            while not stop.wait(0.1):
                if drained():
                    stop.set()
        threading.Thread(target=drain_check, daemon=True).start()

    profile_dir = getattr(args, "profile_dir", None)
    if profile_dir:
        from .profiling import start_trace
        start_trace(profile_dir)
    worker_server = None
    if getattr(args, "listen", None) is not None:
        # MultiKueue worker mode: serve the remote-cluster API next to
        # the admission daemon (remote.WorkerServer)
        from .remote import WorkerServer
        worker_server = WorkerServer(driver, port=args.listen)
        worker_server.start()
        print(f"worker API on http://127.0.0.1:{worker_server.port}",
              flush=True)
    print(f"serving from {args.state_dir} (SIGUSR2 dumps state, "
          f"SIGTERM stops)", flush=True)
    try:
        driver.run(stop)                     # blocks until stop
        if profile_dir:
            from .profiling import stop_trace
            stop_trace()                     # may raise: lease still freed
        # status write-back against a FRESH store read: spec edits made
        # by other processes while serving are preserved, and workloads
        # deleted from the store stay deleted
        final = Store(args.state_dir)
        for wl in list(driver.workloads.values()):
            if final.get("Workload", wl.name, wl.namespace) is not None:
                final.upsert(m.to_manifest(wl))
        final.save()
    finally:
        if worker_server is not None:
            worker_server.stop()
        lease.release()
    admitted = sorted(driver.admitted_keys())
    print(f"serve exiting: {len(admitted)} workloads holding quota")
    return 0


def cmd_import(store: Store, args) -> int:
    """cmd/importer equivalent: adopt already-running pods as admitted
    workloads (check + import phases)."""
    import yaml
    text = (sys.stdin.read() if args.filename == "-"
            else open(args.filename).read())
    driver = build_driver(store, device=args.device)
    count = skipped = 0
    for doc in yaml.safe_load_all(text):
        if not doc or doc.get("kind") != "Pod":
            continue
        meta = doc.get("metadata") or {}
        queue = (meta.get("labels") or {}).get(args.queue_label)
        if not queue:
            skipped += 1
            continue
        spec = doc.get("spec") or {}
        requests: dict[str, int] = {}
        for c in spec.get("containers", []):
            for rname, v in ((c.get("resources") or {})
                             .get("requests") or {}).items():
                requests[rname] = (requests.get(rname, 0)
                                   + m._parse_qty(rname, v))
        req_strs = {r: m._format_qty(r, v) for r, v in requests.items()}
        pod_set = {"name": "main", "count": 1,
                   "template": {"spec": {"containers": [
                       {"name": "main",
                        "resources": {"requests": req_strs}}]}}}
        wl_doc = _mk("Workload", f"pod-{meta.get('name')}",
                     {"queueName": queue, "podSets": [pod_set]},
                     namespace=meta.get("namespace", "default"))
        store.upsert(wl_doc)
        count += 1
    store.save()
    # import phase: admit them through the scheduler
    driver = build_driver(store, device=args.device)
    driver.run_until_settled()
    save_workloads(store, driver)
    store.save()
    print(f"imported {count} pods ({skipped} skipped), "
          f"{len(driver.admitted_keys())} admitted")
    return 0


# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="kueuectl", description="kueue-tpu control CLI")
    parser.add_argument("--state-dir",
                        default=env_value("KUEUE_TPU_STATE"))
    parser.add_argument("--device", default="cuda",
                        help="where every Driver runs: cuda (the CUDA "
                             "kernels; raises without a GPU) or cpu (their "
                             "plain PyTorch versions)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("apply", help="apply -f manifests")
    p.add_argument("-f", "--filename", required=True)

    p = sub.add_parser("create")
    p.add_argument("resource",
                   choices=["clusterqueue", "localqueue", "resourceflavor"])
    p.add_argument("name")
    p.add_argument("--cohort", default="")
    p.add_argument("--nominal-quota", default="",
                   help="cpu=10,memory=64Gi")
    p.add_argument("--flavor", default="default")
    p.add_argument("--clusterqueue", default="")
    p.add_argument("--node-labels", default="")
    p.add_argument("-n", "--namespace", default="default")

    p = sub.add_parser("list")
    p.add_argument("resource")
    p.add_argument("-n", "--namespace", default=None)

    p = sub.add_parser("delete")
    p.add_argument("resource")
    p.add_argument("name")
    p.add_argument("-n", "--namespace", default=None)

    for name in ("stop", "resume"):
        p = sub.add_parser(name)
        p.add_argument("resource",
                       choices=["workload", "clusterqueue", "localqueue"])
        p.add_argument("name")
        p.add_argument("-n", "--namespace", default=None)

    p = sub.add_parser("schedule", help="run admission cycles")
    p.add_argument("--cycles", type=int, default=1000)
    p.add_argument("--device-solver", action="store_true",
                   help="accepted for the reference's command lines: "
                        "cycles are always decided by the device solver "
                        "on --device")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (host and CUDA "
                        "activity, profiling.start_trace) here")

    sub.add_parser("state", help="dump queues/cache state")

    p = sub.add_parser("serve", help="run the admission daemon")
    p.add_argument("--poll-interval", type=float, default=0.5,
                   help="store-watch poll interval (seconds)")
    p.add_argument("--exit-when-drained", action="store_true",
                   help="exit once no workloads are pending (tests)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (host and CUDA "
                        "activity, profiling.start_trace) here")
    p.add_argument("--listen", type=int, default=None,
                   help="serve the MultiKueue worker API on this port")
    p.add_argument("--device-solver", action="store_true",
                   help="accepted for the reference's command lines: "
                        "cycles are always decided by the device solver "
                        "on --device")

    p = sub.add_parser("import", help="bulk-import running pods")
    p.add_argument("-f", "--filename", required=True)
    p.add_argument("--queue-label", default="kueue.x-k8s.io/queue-name")

    sub.add_parser("version")

    args = parser.parse_args(argv)
    if args.command == "version":
        print(VERSION)
        return 0
    store = Store(args.state_dir)
    handlers = {
        "apply": cmd_apply, "create": cmd_create, "list": cmd_list,
        "delete": cmd_delete, "schedule": cmd_schedule, "state": cmd_state,
        "import": cmd_import, "serve": cmd_serve,
        "stop": lambda s, a: _set_stop_policy(s, a, StopPolicy.HOLD_AND_DRAIN),
        "resume": lambda s, a: _set_stop_policy(s, a, StopPolicy.NONE),
    }
    return handlers[args.command](store, args)


if __name__ == "__main__":
    sys.exit(main())
