"""Shapes past the CUDA launchers' old limits (ROADMAP Queue 3): a cohort
chain 17 levels deep for every kernel that walks chains, and fair sharing
over F = 65 and F = 72 flavor-resource columns (8 flavors x 9 resources).
The port's plain versions against the JAX package on the same seeded
inputs (``kueue_tpu_torch.testing.shape_cases``), exact in values and
dtypes; then both packages' Drivers on a 17-deep cohort tree and on a
fair-sharing cluster of 8 flavors x 9 resources, with equal
``Driver.events``.  The CUDA kernels meet the same shapes in
tests/test_torch_kernels_gpu.py and ``chip_smoke.py`` phase 3h."""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kueue_tpu.ops import burst as jburst
from kueue_tpu.ops import cycle as jc
from kueue_tpu.ops import fairsharing_kernel as jfk
from kueue_tpu.ops import fs_scan as jfs
from kueue_tpu.ops import preemption_kernel as jp
from kueue_tpu.ops.quota_kernel import available_all
from kueue_tpu_torch import testing as tt
from kueue_tpu_torch.ops import (burst, cycle, fairsharing_kernel, fs_scan,
                                 preemption_kernel)

torch.set_num_threads(1)

PACKAGES = ("kueue_tpu", "kueue_tpu_torch")


def _jax_cq_avail(usage0, subtree, guaranteed, borrow_cap, has_blim,
                  parent, *, n_cqs, depth):
    q = (subtree, guaranteed, borrow_cap, has_blim, parent)
    return (available_all(usage0, *q, depth)[:n_cqs],
            available_all(jnp.zeros_like(usage0), *q, depth)[:n_cqs])


def _jax_fs(*args, **kw):
    # the JAX scan takes every argument but forest_of_node
    return jfs.fs_admit_scan(*args[:-1], **kw)


JAX = {
    "admit_scan": jc.admit_scan,
    "admit_scan_forests": jc.admit_scan_forests,
    "admit_scan_preempt": jc.admit_scan_preempt,
    "minimal_preemptions_batch": jp.minimal_preemptions_batch,
    "burst_cycles": jburst.burst_cycles,
    "kq_cq_avail": _jax_cq_avail,
    "drs_components": jfk.drs_components,
    "fs_admit_scan": _jax_fs,
}
PLAIN = {
    "admit_scan": cycle.admit_scan_plain,
    "admit_scan_forests": cycle.admit_scan_forests_plain,
    "admit_scan_preempt": cycle.admit_scan_preempt_plain,
    "minimal_preemptions_batch":
        preemption_kernel.minimal_preemptions_batch_plain,
    "burst_cycles": burst.burst_cycles_plain,
    "kq_cq_avail": cycle.cq_avail_plain,
    "drs_components": fairsharing_kernel.drs_components_plain,
    "fs_admit_scan": fs_scan.fs_admit_scan_plain,
}
CASES = list(enumerate(tt.shape_cases(0)))


def _flat(out):
    if not isinstance(out, tuple):
        return [out]
    return [t for x in out for t in _flat(x)]


@pytest.mark.parametrize("i", [i for i, _ in CASES],
                         ids=[f"{c[0]}-{i}" for i, c in CASES])
def test_plain_matches_jax_past_the_old_limits(i):
    name, args, kw = CASES[i][1]
    assert kw["depth"] == 17 or args[0].shape[-1] in (65, 72), (name, kw)
    j = JAX[name](*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                    for a in args], **kw)
    t = PLAIN[name](*[torch.from_numpy(np.ascontiguousarray(a))
                      if isinstance(a, np.ndarray) else a for a in args],
                    **kw)
    j, t = _flat(jax.device_get(j)), _flat(t)
    assert len(j) == len(t)
    for a, b in zip(j, t):
        a = np.asarray(a)
        b = b.numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)      # tgt_words carried as int32
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert np.array_equal(a, b), name


# -- Drivers -----------------------------------------------------------

class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _driver(pkg, clock, fair_sharing=False):
    Driver = importlib.import_module(f"{pkg}.controller.driver").Driver
    if pkg == "kueue_tpu":
        return Driver(clock=clock, use_device_solver=True,
                      fair_sharing=fair_sharing)
    return Driver(clock=clock, device="cpu", fair_sharing=fair_sharing)


def deep_cohorts(t, d, levels=16):
    """A cohort chain ``levels`` deep with two CQs under the deepest
    cohort and one under the first (a 17-level tree), quota only at the
    CQs, preemption within the cohort on."""
    d.apply_resource_flavor(t.ResourceFlavor(name="default"))
    for j in range(levels):
        d.apply_cohort(t.Cohort(name=f"co-{j}",
                                parent_name=f"co-{j - 1}" if j else None))
    pre = t.PreemptionPolicy(
        reclaim_within_cohort=t.ReclaimWithinCohort.ANY,
        within_cluster_queue=t.WithinClusterQueue.LOWER_PRIORITY)
    for q, cohort in enumerate((f"co-{levels - 1}", f"co-{levels - 1}",
                                "co-0")):
        d.apply_cluster_queue(t.ClusterQueue(
            name=f"cq-{q}", cohort=cohort, preemption=pre,
            resource_groups=[t.ResourceGroup(
                covered_resources=["cpu"],
                flavors=[t.FlavorQuotas(name="default", resources={
                    "cpu": t.ResourceQuota(nominal=4000,
                                           borrowing_limit=4000)})])]))
        d.apply_local_queue(t.LocalQueue(name=f"lq-{q}",
                                         cluster_queue=f"cq-{q}"))
    n = 0
    for q in range(3):
        for i in range(8):
            n += 1
            d.create_workload(t.Workload(
                name=f"w-{q}-{i}", queue_name=f"lq-{q}",
                priority=(i % 3) * 10, creation_time=float(n),
                pod_sets=[t.PodSet(name="main", count=1,
                                   requests={"cpu": 1500})]))


def wide_fair_sharing(t, d, flavors=8, resources=9):
    """A fair-sharing cohort of three weighted CQs, each with one
    resource group of ``resources`` resources over ``flavors`` flavors
    (F = flavors x resources), and workloads that fill the first
    flavors and spill into later ones."""
    names = [f"r{r}" for r in range(resources)]
    for f in range(flavors):
        d.apply_resource_flavor(t.ResourceFlavor(name=f"f{f}"))
    for q, w in enumerate((1.0, 2.0, 0.5)):
        d.apply_cluster_queue(t.ClusterQueue(
            name=f"cq-{q}", cohort="co",
            fair_sharing=t.FairSharing(weight=w),
            resource_groups=[t.ResourceGroup(
                covered_resources=names,
                flavors=[t.FlavorQuotas(name=f"f{f}", resources={
                    r: t.ResourceQuota(nominal=1000 * (1 + (f + k) % 3),
                                       borrowing_limit=2000)
                    for k, r in enumerate(names)})
                    for f in range(flavors)])]))
        d.apply_local_queue(t.LocalQueue(name=f"lq-{q}",
                                         cluster_queue=f"cq-{q}"))
    rng = np.random.default_rng(3)
    for k in range(36):
        q = int(rng.integers(3))
        req = {names[int(r)]: int(rng.choice([500, 1500, 2500]))
               for r in rng.choice(resources, 3, replace=False)}
        d.create_workload(t.Workload(
            name=f"w-{k}", queue_name=f"lq-{q}",
            priority=int(rng.choice([0, 10])), creation_time=float(k + 1),
            pod_sets=[t.PodSet(name="main", count=1, requests=req)]))


def _drive(pkg, scenario, cycles, fair_sharing=False, runtime=3):
    clock = Clock()
    d = _driver(pkg, clock, fair_sharing)
    scenario(importlib.import_module(f"{pkg}.api.types"), d)
    admitted = []
    for c in range(cycles):
        clock.t += 1.0
        admitted.append(sorted(d.schedule_once().admitted))
        if c >= runtime:
            for key in admitted[c - runtime]:
                wl = d.workloads.get(key)
                if wl is not None and wl.has_quota_reservation:
                    d.finish_workload(key)
    return d, admitted


@pytest.mark.parametrize("scenario,fair_sharing",
                         [(deep_cohorts, False), (wide_fair_sharing, True)],
                         ids=["cohort-chain-17", "fs-8x9"])
def test_driver_matches_jax_past_the_old_limits(scenario, fair_sharing):
    runs = {p: _drive(p, scenario, 12, fair_sharing) for p in PACKAGES}
    (dj, aj), (dt, at) = runs["kueue_tpu"], runs["kueue_tpu_torch"]
    assert dt.events == dj.events
    assert at == aj
    assert sum(map(len, at)) > 0
    solver = dt.scheduler.solver
    st = solver._structure
    if fair_sharing:
        assert solver.stats["fs_full_cycles"] > 0, solver.stats
        assert st.subtree_quota.shape[1] == 72
    else:
        assert solver.stats["full_cycles"] > 0, solver.stats
        assert st.depth == 17
