"""The provisioning admission check of the port
(``kueue_tpu_torch.admissionchecks``) against the JAX package's: the
provisioning cases of tests/test_admissionchecks.py, each run on both
packages' Drivers (the port's on the CPU), with the reference test's
assertions on each and, after every reconcile, every workload's check
state, message and podset updates, the Driver's events, the request
names, the retry state and the pod templates equal between the two.
Then the scenario that chip_smoke.py drives at 6,000 workloads
(``scenarios.provisioning_spec``), small, on both packages: equal
decisions, and every check outcome reached.  Tolerance 0."""

import importlib
import os
from types import SimpleNamespace

import pytest

from kueue_tpu_torch import scenarios
from tests.conftest import FakeClock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("kueue_tpu", "kueue_tpu_torch")


def package(root):
    """Package ``root``'s modules that the cases use."""
    m = SimpleNamespace(**{
        name.rsplit(".", 1)[-1]: importlib.import_module(f"{root}.{name}")
        for name in ("api.types", "admissionchecks", "features",
                     "controller.driver")})
    m.root = root
    return m


def driver(m, clock, **kw):
    if m.root == "kueue_tpu_torch":
        kw["device"] = "cpu"
    return m.driver.Driver(clock=clock, **kw)


def make_cluster(m, clock, nominal=5000, checks=()):
    t = m.types
    d = driver(m, clock)
    d.apply_resource_flavor(t.ResourceFlavor(name="default"))
    for c in checks:
        d.apply_admission_check(t.AdmissionCheck(name=c))
    d.apply_cluster_queue(t.ClusterQueue(
        name="cq", admission_checks=list(checks),
        resource_groups=[t.ResourceGroup(
            covered_resources=["cpu"],
            flavors=[t.FlavorQuotas(name="default", resources={
                "cpu": t.ResourceQuota(nominal=nominal)})])]))
    d.apply_local_queue(t.LocalQueue(name="lq", cluster_queue="cq"))
    return d


def wl(m, name, cpu=1000, created=1.0):
    t = m.types
    return t.Workload(name=name, queue_name="lq", creation_time=created,
                      pod_sets=[t.PodSet(name="main", count=1,
                                         requests={"cpu": cpu})])


class Run:
    """One case on one package: the cluster, the controller over a
    capacity backend whose outcome the case sets, and what each
    reconcile left (``step``)."""

    def __init__(self, m, outcome="Provisioned", limit=2):
        t = m.types
        self.clock = FakeClock()
        self.d = make_cluster(m, self.clock, checks=("prov",))
        self.outcomes = {"value": outcome}

        def backend(req):
            req.state = self.outcomes["value"]
            if req.state != "Provisioned":
                req.failure_message = "zone stockout"

        self.ctrl = m.admissionchecks.ProvisioningController(
            self.d, check_name="prov",
            config=t.ProvisioningRequestConfig(
                name="prov-config",
                provisioning_class_name="queued-provisioning",
                retry_strategy=t.ProvisioningRequestRetryStrategy(
                    backoff_limit_count=limit, backoff_base_seconds=60)),
            capacity_backend=backend)
        self.steps = []

    def reconcile(self, settle=True):
        if settle:
            self.d.run_until_settled()
        self.ctrl.reconcile()
        self.steps.append(self.observe())

    def observe(self):
        d, ctrl = self.d, self.ctrl
        checks = {}
        for key, w in sorted(d.workloads.items()):
            checks[key] = [w.is_admitted, w.is_active, w.is_finished,
                           w.has_quota_reservation] + [
                [n, st.state.value, st.message, st.pod_set_updates]
                for n, st in sorted(w.admission_check_states.items())]
        return dict(
            checks=checks, events=[list(e) for e in d.events],
            requests={k: [r.name, r.attempt, r.state, r.pod_sets]
                      for k, r in sorted(ctrl.requests.items())},
            retry=sorted(ctrl.retry_state.items()),
            templates={k: [p.requests, p.count, sorted(
                p.node_selector.items())]
                for k, p in sorted(ctrl.pod_templates.items())})

    def request(self, key):
        return next(r for r in self.ctrl.requests.values()
                    if r.workload_key == key)

    def workload(self, key):
        return self.d.workloads[key]

    def state(self, key):
        return self.workload(key).admission_check_states["prov"].state.value


def success_with_podset_updates(m):
    r = Run(m)
    r.d.create_workload(wl(m, "needs-nodes"))
    r.reconcile()
    w = r.workload("default/needs-nodes")
    assert r.state("default/needs-nodes") == "Ready"
    assert w.is_admitted
    anns = w.admission_check_states["prov"].pod_set_updates[0][
        "annotations"]
    assert anns["cluster-autoscaler.kubernetes.io/provisioning-class-name"] \
        == "queued-provisioning"
    return r


def failure_backoff_then_reject(m):
    r = Run(m, outcome="Failed", limit=2)
    r.d.create_workload(wl(m, "doomed"))
    r.reconcile()
    assert r.ctrl.retry_state["default/doomed"][0] == 2
    r.reconcile()
    assert not [q for q in r.ctrl.requests.values()
                if q.workload_key == "default/doomed" and q.attempt == 2]
    r.clock.tick(61.0)
    r.reconcile()
    w = r.workload("default/doomed")
    assert not w.is_active and not w.is_admitted
    return r


def recovers_on_second_attempt(m):
    r = Run(m, outcome="Failed", limit=3)
    r.d.create_workload(wl(m, "flaky"))
    r.reconcile()
    assert r.ctrl.retry_state["default/flaky"][0] == 2
    r.outcomes["value"] = "Provisioned"
    r.clock.tick(61.0)
    r.reconcile()
    assert r.state("default/flaky") == "Ready"
    assert r.workload("default/flaky").is_admitted
    return r


def pod_templates_with_flavor_selectors(m):
    r = Run(m)
    r.d.apply_resource_flavor(m.types.ResourceFlavor(
        name="default", node_labels={"cloud.com/type": "tpu-v5e"}))
    r.d.create_workload(wl(m, "templated"))
    r.reconcile()
    req = r.request("default/templated")
    assert req.pod_sets[0]["pod_template_ref"] == f"ppt-{req.name}-main"
    pt = r.ctrl.pod_templates[
        f"default/{req.pod_sets[0]['pod_template_ref']}"]
    assert pt.requests == {"cpu": 1000} and pt.count == 1
    assert pt.node_selector["cloud.com/type"] == "tpu-v5e"
    return r


def pod_templates_resynced_and_gcd(m):
    r = Run(m)
    r.d.create_workload(wl(m, "resync"))
    r.reconcile()
    ref = next(iter(r.ctrl.pod_templates))
    del r.ctrl.pod_templates[ref]
    r.reconcile(settle=False)
    assert ref in r.ctrl.pod_templates
    r.d.finish_workload("default/resync")
    r.reconcile(settle=False)
    assert r.ctrl.pod_templates == {}
    assert all(q.workload_key != "default/resync"
               for q in r.ctrl.requests.values())
    return r


def capacity_revoked_rejects_admitted(m):
    r = Run(m)
    r.d.create_workload(wl(m, "revoked"))
    r.reconcile()
    assert r.workload("default/revoked").is_admitted
    req = r.request("default/revoked")
    req.state = "CapacityRevoked"
    req.failure_message = "nodes deleted"
    r.reconcile(settle=False)
    w = r.workload("default/revoked")
    assert not w.is_active and not w.is_admitted
    return r


def booking_expired_ignored_while_admitted(m):
    r = Run(m)
    r.d.create_workload(wl(m, "booked"))
    r.reconcile()
    r.request("default/booked").state = "BookingExpired"
    r.reconcile(settle=False)
    assert r.workload("default/booked").is_admitted
    assert r.state("default/booked") == "Ready"
    return r


def booking_expired_retries_before_admission(m):
    r = Run(m, outcome="BookingExpired", limit=3)
    r.d.create_workload(wl(m, "expired"))
    r.reconcile()
    assert r.ctrl.retry_state["default/expired"][0] == 2
    r.outcomes["value"] = "Provisioned"
    r.clock.tick(61.0)
    r.reconcile()
    assert r.state("default/expired") == "Ready"
    return r


def keep_quota_gate_retries_without_eviction(m):
    r = Run(m, outcome="Failed", limit=3)
    with m.features.set_feature_gate_during_test(
            "KeepQuotaForProvReqRetry", True):
        r.d.create_workload(wl(m, "kept"))
        r.reconcile()
        w = r.workload("default/kept")
        assert r.ctrl.retry_state["default/kept"][0] == 2
        assert r.state("default/kept") == "Pending"
        assert w.has_quota_reservation
        r.outcomes["value"] = "Provisioned"
        r.clock.tick(61.0)
        r.reconcile(settle=False)
        assert r.workload("default/kept").is_admitted
    return r


CASES = (success_with_podset_updates, failure_backoff_then_reject,
         recovers_on_second_attempt, pod_templates_with_flavor_selectors,
         pod_templates_resynced_and_gcd, capacity_revoked_rejects_admitted,
         booking_expired_ignored_while_admitted,
         booking_expired_retries_before_admission,
         keep_quota_gate_retries_without_eviction)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_provisioning_case_on_both_packages(case):
    jax_run = case(package("kueue_tpu"))
    port_run = case(package("kueue_tpu_torch"))
    assert len(port_run.steps) == len(jax_run.steps) > 0
    for i, (j, p) in enumerate(zip(jax_run.steps, port_run.steps)):
        for k in j:
            assert p[k] == j[k], (i, k)


def test_init_differs_only_by_the_multikueue_names():
    """The port's ``admissionchecks/__init__.py`` lacked only the
    MultiKueue import and names until the remote plane came; with
    ``multikueue.py`` ported it is the reference's file, and both
    packages export the same names, the MultiKueue ones among them."""
    def read(path):
        with open(path, "rb") as fh:
            return fh.read()
    assert read(os.path.join(
        ROOT, "kueue_tpu_torch/admissionchecks/__init__.py")) == read(
        os.path.join(ROOT, "kueue_tpu/admissionchecks/__init__.py"))
    import kueue_tpu.admissionchecks as ref
    from kueue_tpu_torch import admissionchecks
    assert admissionchecks.__all__ == ref.__all__
    assert {"MULTIKUEUE_CONTROLLER_NAME", "MultiKueueController",
            "WorkerCluster", "PROVISIONING_CONTROLLER_NAME",
            "ProvisioningController",
            "ProvisioningRequest"} == set(admissionchecks.__all__)


@pytest.mark.parametrize("seed", [0, 1])
def test_provisioning_scenario_on_both_packages(seed):
    """chip_smoke.py phase 20's scenario at 120 workloads: the port's
    Driver on the CPU and the JAX package's decide the
    same reservations and check writes cycle by cycle; every outcome of
    the capacity backend shows, and every workload ends finished or
    rejected.  The JAX Driver runs its device solver, as
    tests/test_torch_driver.py's does: its host path orders a cycle's
    Preempted events otherwise."""
    out = {}
    for root in PACKAGES:
        m = package(root)
        clock = scenarios.VirtualClock()
        kw = {} if root == "kueue_tpu_torch" else dict(
            use_device_solver=True)
        d = driver(m, clock, **kw)
        ctrl, total, waves, revoke = scenarios.provisioning_spec(
            m.types, m.admissionchecks, d, scale=0.008, seed=seed)
        out[root] = scenarios.run_provisioning(d, clock, ctrl, total, waves,
                                               revoke)
        out[root]["events"] = [list(e) for e in d.events]
    j, p = out["kueue_tpu"], out["kueue_tpu_torch"]
    for k in ("decisions", "events", "reached", "requests", "cycles",
              "admitted", "finished", "rejected"):
        assert p[k] == j[k], k
    assert p["finished"] + p["rejected"] == p["total"] == 120
    assert {"Ready: Provisioned", "Retry: Retrying after Failed",
            "Retry: Retrying after booking expired",
            "Rejected: CapacityRevoked"} <= set(p["reached"]), p["reached"]


def test_capacity_outcome_is_seeded():
    """The backend's answers are a function of (seed, request name,
    attempt) alone, and cover every outcome over a few hundred names."""
    got = [scenarios.capacity_outcome(0, f"wl-{i}-prov-1", 1)
           for i in range(400)]
    assert got == [scenarios.capacity_outcome(0, f"wl-{i}-prov-1", 1)
                   for i in range(400)]
    assert set(got) == {"Provisioned", "Failed", "BookingExpired", "Revoke"}
    assert {scenarios.capacity_outcome(0, f"wl-{i}-prov-2", 2)
            for i in range(400)} == {"Provisioned", "Failed"}
