"""Topology-aware scheduling on device (SURVEY §7 stage 7).

The domain tree (block → rack → host) becomes level-indexed arrays; the
reference's two-phase algorithm (tas_flavor_snapshot.go:406-613)
becomes:

- phase 1 ``fill_counts``: leaf fits = min over resources of
  free // per_pod, then a segment sum up the levels;
- phase 2 ``best_fit_descend``: pick the best domain at the requested
  level (least spare capacity, BestFit), then descend level by level
  allocating children in (-state, id) order;
- ``split_across_roots``: the unconstrained / final-fallback split of the
  count over every root domain, then the same descent.

Each has a plain PyTorch version (``*_plain``), a literal translation of
the JAX package's jitted programs (in-segment prefix sums and running
maxima over a lexsorted level), and a hand-written CUDA kernel
(``kernels/tas_fill_counts.cu``, ``kernels/tas_descend.cu``).  The routed
functions take a ``device``: inputs that are not tensors go there (the
card unless the caller asks for the CPU), CPU tensors run the plain
version and CUDA tensors launch the kernel — there is no fallback.

Domains at every level are packed sorted by id tuple, so children of one
parent are contiguous, and index order is id order (the reference's
tie-break).  ``PackedTAS`` and ``pack_tas`` are the JAX package's host
numpy, unchanged.  All arithmetic is int32 and wraps like XLA's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..cache.tas_snapshot import TASFlavorSnapshot

I32_MAX = 2**31 - 1
PROFILES = ("bestfit", "mostfree", "leastfree")


@dataclass
class PackedTAS:
    levels: list[str]
    level_sizes: list[int]            # domains per level, top→bottom
    parents: list[np.ndarray]         # parents[l]: [N_{l+1}] → level-l idx
    leaf_free: np.ndarray             # [N_leaf, R] int32
    resource_names: list[str]
    leaf_ids: list[tuple]             # leaf idx → id tuple
    domain_ids: list[list[tuple]]     # per level, idx → id tuple


def pack_tas(snap: TASFlavorSnapshot) -> PackedTAS:
    L = len(snap.levels)
    domain_ids = [sorted(d.id for d in snap.domains_per_level[lvl])
                  for lvl in range(L)]
    idx = [{did: i for i, did in enumerate(domain_ids[lvl])}
           for lvl in range(L)]
    parents = []
    for lvl in range(1, L):
        par = np.array([idx[lvl - 1][did[:lvl]] for did in domain_ids[lvl]],
                       dtype=np.int32)
        parents.append(par)
    resources = sorted({r for leaf in snap.leaves.values()
                        for r in leaf.free})
    r_index = {r: i for i, r in enumerate(resources)}
    leaf_ids = domain_ids[L - 1]
    leaf_free = np.zeros((max(1, len(leaf_ids)), max(1, len(resources))),
                         dtype=np.int64)
    for i, did in enumerate(leaf_ids):
        for r, v in snap.leaves[did].free.items():
            leaf_free[i, r_index[r]] = min(max(v, 0), I32_MAX)
    return PackedTAS(levels=list(snap.levels),
                     level_sizes=[len(d) for d in domain_ids],
                     parents=parents,
                     leaf_free=leaf_free.astype(np.int32),
                     resource_names=resources,
                     leaf_ids=list(leaf_ids), domain_ids=domain_ids)


def tas_planes(packed: PackedTAS, device) -> tuple[torch.Tensor, ...]:
    """The static planes of one snapshot on ``device``: its parents, a
    tuple of int32 tensors."""
    return tuple(torch.from_numpy(np.ascontiguousarray(p)).to(device)
                 for p in packed.parents)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the JAX programs, line for line)
# ---------------------------------------------------------------------------

def _wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32, wrapping like XLA's int32 arithmetic."""
    return x.to(torch.int32)


def _neg(x: torch.Tensor) -> torch.Tensor:
    return _wrap(-x.long())


def fill_counts_plain(leaf_free, per_pod, parents, *, level_sizes):
    """Returns states per level (tuple of int32 tensors, top→bottom).

    leaf_free: [N_leaf, R]; per_pod: [R] (0 = not requested);
    parents: tuple of [N_{l+1}] tensors."""
    needed = per_pod > 0
    q = torch.div(leaf_free, per_pod.clamp(min=1)[None, :],
                  rounding_mode="floor")
    fits_r = torch.where(needed[None, :], q, torch.full_like(q, I32_MAX))
    leaf_state = fits_r.min(dim=1).values                # [N_leaf]
    leaf_state = torch.where(needed.any(), leaf_state,
                             torch.zeros_like(leaf_state))
    states = [leaf_state]
    for lvl in range(len(level_sizes) - 2, -1, -1):
        child = states[0]
        acc = torch.zeros(level_sizes[lvl], dtype=torch.int64,
                          device=child.device)
        acc.index_add_(0, parents[lvl].long(), child.long())
        states.insert(0, _wrap(acc))
    return tuple(states)


def _best_at_level(state, count, profile: str):
    """Single fitting domain per profile (_find_fit_at): BestFit and
    LeastFree pick the least spare capacity, MostFree the most free —
    ties by index (= id order).  Returns -1 when none fits."""
    fits = state >= count
    if profile == "mostfree":
        key = torch.where(fits, _neg(state), I32_MAX)
    else:
        key = torch.where(fits, state, I32_MAX)
    idx = torch.arange(state.shape[0], device=state.device)
    best = torch.where(key == key.min(), idx, state.shape[0]).min()
    return torch.where(fits.any(), best, -1)


def _seg_start(first):
    """Position of each element's segment start."""
    idx = torch.arange(first.shape[0], device=first.device)
    return torch.cummax(torch.where(first, idx, 0), 0).values


def _seg_scan_sum(values, first):
    """Inclusive in-segment prefix sum, wrapping int32 (segments = runs
    where first marks the start)."""
    v = values.long()
    cs = v.cumsum(0)
    s = _seg_start(first)
    return _wrap(cs - (cs[s] - v[s]))


def _seg_broadcast_max(values, first):
    """Inclusive in-segment running max."""
    off = (first.long().cumsum(0) - 1) * 2**33   # later segments higher
    return _wrap(torch.cummax(values.long() + off, 0).values - off)


def _allocate_level(parent_counts, par, state, profile: str = "bestfit"):
    """Distribute parent counts over children in sortedDomains order
    (updateCountsToMinimum, tas_flavor_snapshot.go:571): take whole
    domains in profile order; under BestFit, once the remainder fits a
    single domain, give it to the tightest domain that still fits it
    (MostFree/LeastFree hand the remainder to the first in-order fit —
    the plain greedy walk).  LeastFree reverses the (-state, id) order,
    so equal-state ties run in id-DESCENDING order there.

    parent_counts: [N_l]; par: [N_{l+1}] parent idx; state: [N_{l+1}].
    Returns child_counts [N_{l+1}]."""
    n = state.shape[0]
    dev = state.device
    idx = torch.arange(n, device=dev)
    # jnp.lexsort((tie, key, par)): a stable sort by (par, key) over the
    # tie-break order
    if profile == "leastfree":
        base, key = idx.flip(0), state.long()
    else:
        base, key = idx, _neg(state).long()
    comp = par.long() * 2**32 + (key + 2**31)
    order = base[torch.sort(comp[base], stable=True).indices]
    par_o = par[order]
    state_o = state[order]
    true1 = torch.ones(1, dtype=torch.bool, device=dev)
    first = torch.cat([true1, par_o[1:] != par_o[:-1]])
    # in-segment exclusive prefix sum of state
    exc = _wrap(_seg_scan_sum(state_o, first).long() - state_o.long())
    cnt_o = parent_counts[par_o.long()]
    remaining = _wrap(cnt_o.long() - exc.long())         # before child k
    absorb = (state_o >= remaining) & (remaining > 0)
    # j = first absorbing child per segment; positions k < j have
    # state < remaining (so greedy = full state); positions k >= j give
    # the remainder to the tightest fitting child
    ab_count = _seg_scan_sum(absorb.to(torch.int32), first)
    is_j = absorb & (ab_count == 1)
    has_j = ab_count >= 1                                # running: k >= j
    rem_j = _seg_broadcast_max(torch.where(is_j, remaining, 0), first)
    # best-fit last domain: the tightest child (min state, ties by id =
    # position order) with state >= rem_j — always at index >= j
    cand = (has_j & (rem_j > 0) & (state_o >= rem_j)) | is_j
    par_r = par_o.flip(0)
    first_rev = torch.cat([true1, par_r[1:] != par_r[:-1]])
    # min candidate state per segment = state at the last candidate
    # (desc order); broadcast it backward over the segment
    cand_rev_count = _seg_scan_sum(cand.flip(0).to(torch.int32), first_rev)
    is_last_cand = (cand.flip(0) & (cand_rev_count == 1)).flip(0)
    min_state = _seg_broadcast_max(
        torch.where(is_last_cand.flip(0), state_o.flip(0), 0),
        first_rev).flip(0)
    # the pick: FIRST candidate holding the minimal state (id tie-break)
    tight = cand & (state_o == min_state)
    tight_count = _seg_scan_sum(tight.to(torch.int32), first)
    is_pick = tight & (tight_count == 1)

    # jnp.clip(remaining, 0, state_o) = minimum(state_o, maximum(0, .))
    greedy = torch.minimum(state_o, remaining.clamp(min=0))
    if profile == "bestfit":
        take_o = torch.where(has_j, torch.where(is_pick, rem_j, 0), greedy)
    else:
        take_o = greedy      # _select_from without the last-domain pick
    out = torch.zeros(n, dtype=parent_counts.dtype, device=dev)
    return out.scatter(0, order, take_o.to(parent_counts.dtype))


def best_fit_descend_plain(leaf_free, per_pod, parents, count,
                           *, level_sizes, level: int,
                           profile: str = "bestfit"):
    """Single-domain selection at `level` + descent to leaf counts,
    under the requested TAS profile (tas_flavor_snapshot.go:551-568).

    Returns (ok bool, leaf_counts [N_leaf] int32); ok=False when no
    single domain at `level` fits `count`."""
    states = fill_counts_plain(leaf_free, per_pod, parents,
                               level_sizes=level_sizes)
    best = _best_at_level(states[level], count, profile)
    ok = best >= 0
    dev = leaf_free.device
    counts = torch.zeros(level_sizes[level], dtype=torch.int32, device=dev)
    val = torch.where(ok, count, 0).to(torch.int32)
    counts = counts.scatter(0, best.clamp(min=0).view(1), val.view(1))
    for lvl in range(level, len(level_sizes) - 1):
        counts = _allocate_level(counts, parents[lvl], states[lvl + 1],
                                 profile)
    return ok, counts


def split_across_roots_plain(leaf_free, per_pod, parents, count,
                             *, level_sizes, profile: str = "bestfit",
                             descend_profile: str | None = None):
    """The unconstrained / final-fallback path: split over root domains
    in ``profile`` order (reference `unconstrained` + root split), then
    descend in ``descend_profile`` order.  They differ only under the
    Mixed gate: its unconstrained variant selects roots least-free but
    the per-level descent (_descend -> _sorted_domains without the
    unconstrained flag) stays on the non-unconstrained profile.

    Returns (ok, leaf_counts)."""
    if descend_profile is None:
        descend_profile = profile
    states = fill_counts_plain(leaf_free, per_pod, parents,
                               level_sizes=level_sizes)
    root_state = states[0]
    total = _wrap(root_state.long().sum())
    ok = total >= count
    n = root_state.shape[0]
    dev = leaf_free.device
    counts = _allocate_level(
        torch.tensor([count], dtype=torch.int32, device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev), root_state, profile)
    counts = torch.where(ok, counts, 0)
    for lvl in range(0, len(level_sizes) - 1):
        counts = _allocate_level(counts, parents[lvl], states[lvl + 1],
                                 descend_profile)
    return ok, counts


# ---------------------------------------------------------------------------
# Routed entry points
# ---------------------------------------------------------------------------

def _to_device(device, leaf_free, per_pod, parents):
    """Tensors on ``device`` (inputs that are tensors stay where they are
    when ``device`` is None; anything else goes to the card)."""
    if device is None:
        device = (leaf_free.device if isinstance(leaf_free, torch.Tensor)
                  else "cuda")

    def on(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return on(leaf_free), on(per_pod), tuple(on(p) for p in parents)


def _check_profile(*profiles) -> None:
    for p in profiles:
        if p not in PROFILES:
            raise ValueError(f"profile {p!r}: one of {PROFILES}")


def _check_count(count) -> int:
    count = int(count)
    if not -2**31 <= count <= I32_MAX:
        raise OverflowError(f"count={count} outside int32")
    return count


def fill_counts(leaf_free, per_pod, parents, *, level_sizes, device=None):
    """Per-level states: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    leaf_free, per_pod, parents = _to_device(device, leaf_free, per_pod,
                                             parents)
    level_sizes = tuple(int(s) for s in level_sizes)
    dev = leaf_free.device
    if dev.type == "cuda":
        from .. import kernels
        return kernels.fill_counts(leaf_free, per_pod, parents,
                                   level_sizes=level_sizes)
    if dev.type != "cpu":
        raise ValueError(f"no fill_counts kernel for device {dev}")
    return fill_counts_plain(leaf_free, per_pod, parents,
                             level_sizes=level_sizes)


def best_fit_descend(leaf_free, per_pod, parents, count, *, level_sizes,
                     level: int, profile: str = "bestfit", device=None):
    """(ok, leaf_counts): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; arguments as ``best_fit_descend_plain``."""
    _check_profile(profile)
    count = _check_count(count)
    leaf_free, per_pod, parents = _to_device(device, leaf_free, per_pod,
                                             parents)
    level_sizes = tuple(int(s) for s in level_sizes)
    if not 0 <= level < len(level_sizes):
        raise ValueError(f"level={level} outside the {len(level_sizes)} "
                         "levels")
    dev = leaf_free.device
    if dev.type == "cuda":
        from .. import kernels
        return kernels.best_fit_descend(
            leaf_free, per_pod, parents, count, level_sizes=level_sizes,
            level=level, profile=profile)
    if dev.type != "cpu":
        raise ValueError(f"no best_fit_descend kernel for device {dev}")
    return best_fit_descend_plain(leaf_free, per_pod, parents, count,
                                  level_sizes=level_sizes, level=level,
                                  profile=profile)


def split_across_roots(leaf_free, per_pod, parents, count, *, level_sizes,
                       profile: str = "bestfit",
                       descend_profile: str | None = None, device=None):
    """(ok, leaf_counts): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; arguments as ``split_across_roots_plain``."""
    if descend_profile is None:
        descend_profile = profile
    _check_profile(profile, descend_profile)
    count = _check_count(count)
    leaf_free, per_pod, parents = _to_device(device, leaf_free, per_pod,
                                             parents)
    level_sizes = tuple(int(s) for s in level_sizes)
    dev = leaf_free.device
    if dev.type == "cuda":
        from .. import kernels
        return kernels.split_across_roots(
            leaf_free, per_pod, parents, count, level_sizes=level_sizes,
            profile=profile, descend_profile=descend_profile)
    if dev.type != "cpu":
        raise ValueError(f"no split_across_roots kernel for device {dev}")
    return split_across_roots_plain(leaf_free, per_pod, parents, count,
                                    level_sizes=level_sizes, profile=profile,
                                    descend_profile=descend_profile)
