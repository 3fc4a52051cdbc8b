"""Each CUDA kernel of kueue_tpu_torch against its plain PyTorch version
on the same seeded inputs (kueue_tpu_torch.testing.kernel_cases,
burst_cases, fs_cases and tas_cases): exact equality, as every output
is bool or int32.  Needs a CUDA GPU — the kernels have no CPU mode —
and skips without one.  This file imports no JAX, so it
also runs on a machine with only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from kueue_tpu_torch import testing as tt
from kueue_tpu_torch.ops import (burst, cycle, fairsharing_kernel, fs_scan,
                                 preemption_kernel)

PLAIN = {
    "admit_scan": cycle.admit_scan_plain,
    "admit_scan_forests": cycle.admit_scan_forests_plain,
    "admit_scan_preempt": cycle.admit_scan_preempt_plain,
    "minimal_preemptions_batch":
        preemption_kernel.minimal_preemptions_batch_plain,
}
ROUTED = {
    "admit_scan": cycle.admit_scan,
    "admit_scan_forests": cycle.admit_scan_forests,
    "admit_scan_preempt": cycle.admit_scan_preempt,
    "minimal_preemptions_batch": preemption_kernel.minimal_preemptions_batch,
}


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_kernels_match_plain(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    seen = set()
    for name, args, kw in tt.kernel_cases(seed):
        before = kernels.LAUNCHES[name]
        plain = PLAIN[name](*[torch.from_numpy(a) for a in args], **kw)
        cuda = ROUTED[name](*[torch.from_numpy(a).cuda() for a in args],
                            **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1, name
        plain = plain if isinstance(plain, tuple) else (plain,)
        cuda = cuda if isinstance(cuda, tuple) else (cuda,)
        for p, c in zip(plain, cuda):
            assert c.dtype == p.dtype and c.shape == p.shape, name
            assert np.array_equal(c.cpu().numpy(), p.numpy()), name
        seen.add(name)
    assert seen == set(PLAIN)


@pytest.mark.gpu
def test_cuda_launcher_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    name, args, kw = next(tt.kernel_cases(0))
    good = [torch.from_numpy(a).cuda() for a in args]
    bad = list(good)
    bad[0] = bad[0].to(torch.int64)             # usage0 must be int32
    with pytest.raises(TypeError):
        kernels.admit_scan(*bad, **kw)
    bad = list(good)
    bad[4] = bad[4].cpu()                       # has_blim on the wrong device
    with pytest.raises(ValueError):
        kernels.admit_scan(*bad, **kw)
    with pytest.raises(ValueError):
        kernels.admit_scan(*good, depth=kernels.MAX_DEPTH + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_burst_matches_plain(seed):
    """burst_cycles on the card against burst_cycles_plain on the CPU:
    the seven outputs and the nine carry planes, exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    for label, args, kw in tt.burst_cases(seed):
        cpu = [torch.from_numpy(np.ascontiguousarray(a))
               if isinstance(a, np.ndarray) else int(a) for a in args]
        before = kernels.LAUNCHES["burst_cycles"]
        plain = burst.burst_cycles_plain(*cpu, **kw)
        cuda = burst.burst_cycles(*[a.cuda() if isinstance(a, torch.Tensor)
                                    else a for a in cpu], **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["burst_cycles"] == before + 1, label
        flat_p = list(plain[:7]) + list(plain[7])
        flat_c = list(cuda[:7]) + list(cuda[7])
        for i, (p, c) in enumerate(zip(flat_p, flat_c)):
            assert c.dtype == p.dtype and c.shape == p.shape, (label, i)
            assert torch.equal(c.cpu(), p), (label, i)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_fair_sharing_kernels_match_plain(seed):
    """fs_admit_scan and drs_components on the card against their plain
    versions on the CPU (kueue_tpu_torch.testing.fs_cases: nested
    cohorts, N on both sides of 64, ties, zero weights, NoFit heads,
    padding, the floor-division cycle, the north-star width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    plain = {"fs_admit_scan": fs_scan.fs_admit_scan_plain,
             "drs_components": fairsharing_kernel.drs_components_plain}
    routed = {"fs_admit_scan": fs_scan.fs_admit_scan,
              "drs_components": fairsharing_kernel.drs_components}
    seen = set()
    for name, args, kw in tt.fs_cases(seed):
        before = kernels.LAUNCHES[name]
        p = plain[name](*[torch.from_numpy(a) for a in args], **kw)
        c = routed[name](*[torch.from_numpy(a).cuda() for a in args], **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1, name
        for x, y in zip(p, c):
            assert y.dtype == x.dtype and y.shape == x.shape, name
            assert torch.equal(y.cpu(), x), name
        seen.add(name)
    assert seen == set(plain)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_tas_kernels_match_plain(seed):
    """fill_counts, best_fit_descend and split_across_roots on the card
    against their plain versions on the CPU
    (kueue_tpu_torch.testing.tas_cases: 1-3 levels, ragged trees, ties,
    every profile and Mixed's unconstrained variant, every request
    shape, counts 0 to above the total, a wrapping sum, a flat level of
    4,096 roots and a tree at the tas-4k shape): values and dtypes
    exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    from kueue_tpu_torch.ops import tas_kernel

    def on(args, device):
        return [tuple(torch.from_numpy(p).to(device) for p in a)
                if isinstance(a, tuple) else
                torch.from_numpy(a).to(device) if isinstance(a, np.ndarray)
                else a for a in args]

    seen = set()
    for name, args, kw in tt.tas_cases(seed, tt.TAS_PARTS + ("tas4k",),
                                       flat=4096):
        before = kernels.LAUNCHES[name]
        p = getattr(tas_kernel, name + "_plain")(*on(args, "cpu"), **kw)
        c = getattr(tas_kernel, name)(*on(args, "cuda"), **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1, name
        assert len(p) == len(c), name
        for x, y in zip(p, c):
            assert y.dtype == x.dtype and y.shape == x.shape, (name, kw)
            assert torch.equal(y.cpu(), x), (name, kw)
        seen.add(name)
    assert seen == {"fill_counts", "best_fit_descend", "split_across_roots"}


@pytest.mark.gpu
def test_cuda_tas_sort_in_global_memory(monkeypatch):
    """With no shared memory allowed for the sort, the descent kernels
    sort in global scratch and still equal their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from kueue_tpu_torch import kernels
    from kueue_tpu_torch.ops import tas_kernel
    monkeypatch.setattr(kernels, "TAS_SMEM_SORT", 0)
    for name, args, kw in tt.tas_cases(0, ("three_levels", "flat")):
        if name == "fill_counts":
            continue
        cpu = [tuple(torch.from_numpy(p) for p in a) if isinstance(a, tuple)
               else torch.from_numpy(a) if isinstance(a, np.ndarray) else a
               for a in args]
        cuda = [tuple(p.cuda() for p in a) if isinstance(a, tuple)
                else a.cuda() if isinstance(a, torch.Tensor) else a
                for a in cpu]
        p = getattr(tas_kernel, name + "_plain")(*cpu, **kw)
        c = getattr(tas_kernel, name)(*cuda, **kw)
        for x, y in zip(p, c):
            assert y.dtype == x.dtype and torch.equal(y.cpu(), x), (name, kw)
