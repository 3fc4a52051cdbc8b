// Native cycle core: the batched nominate/classify pass AND the
// sequential admit scan of the admission cycle (the same semantics as
// kueue_tpu/ops/cycle.py solve_cycle / admit_scan, which themselves
// mirror reference flavorassigner.go:499/:692 and scheduler.go:176-284)
// as a C library.
//
// This is the CPU-native backend of the solver plane: deployments without
// an accelerator (or cycles too small to amortize a device dispatch) run
// the identical classification + admit loop here; decision parity with
// both the JAX kernels and the scalar host oracle is enforced by
// tests/test_native_core.py.
//
// Build: g++ -O2 -shared -fPIC -o libcyclecore.so cycle_core.cpp
// (driven lazily by kueue_tpu/native/__init__.py).

#include <cstdint>
#include <vector>
#include <algorithm>

namespace {

// available() for one (node, fr): top-down fold over the parent chain
// (reference resource_node.go:89; mirrors ops/quota_kernel.available_all).
int64_t available(int node, int f, int F,
                  const int32_t* usage, const int32_t* subtree,
                  const int32_t* guaranteed, const int32_t* borrow_cap,
                  const uint8_t* has_blim, const int32_t* parent) {
    // collect the chain root→node
    std::vector<int> chain;
    for (int cur = node; cur >= 0; cur = parent[cur]) chain.push_back(cur);
    // root first
    int root = chain.back();
    int64_t avail = (int64_t)subtree[root * F + f] - usage[root * F + f];
    for (int i = (int)chain.size() - 2; i >= 0; --i) {
        int cur = chain[i];
        int64_t u = usage[cur * F + f];
        int64_t g = guaranteed[cur * F + f];
        int64_t local = std::max<int64_t>(0, g - u);
        int64_t parent_avail = avail;
        if (has_blim[cur * F + f]) {
            int64_t used_in_parent = std::max<int64_t>(0, u - g);
            int64_t blim_cap = (int64_t)borrow_cap[cur * F + f] - used_in_parent;
            parent_avail = std::min(blim_cap, parent_avail);
        }
        avail = local + parent_avail;
    }
    return avail;
}

}  // namespace

extern "C" {

// Classify every (workload, slot) pair; outputs per workload:
//   fit_slot[w]  : first Fit slot index or -1
//   borrows[w]   : the chosen slot borrows (usage+req > subtreeQuota, in cohort)
//   preempt[w]   : no Fit anywhere but some slot is preempt-capable
// Mirrors ops/cycle.py classify() exactly (per-resource mode lattice).
void classify_cycle(
    int32_t N, int32_t F, int32_t C, int32_t S, int32_t R, int32_t W,
    const int32_t* usage0,        // [N,F]
    const int32_t* subtree,       // [N,F]
    const int32_t* guaranteed,    // [N,F]
    const int32_t* borrow_cap,    // [N,F]
    const uint8_t* has_blim,      // [N,F]
    const int32_t* parent,        // [N]
    const int32_t* nominal_cq,    // [C,F]
    const int32_t* slot_fr,       // [C,S,R] F-index or -1
    const uint8_t* slot_valid,    // [C,S]
    const uint8_t* cq_can_preempt_borrow,  // [C]
    const int32_t* wl_cq,         // [W]
    const int32_t* wl_requests,   // [W,R]
    int32_t* fit_slot_out,        // [W]
    uint8_t* borrows_out,         // [W]
    uint8_t* preempt_out) {       // [W]

    // potential available = available with zero usage; precompute per (n,f)
    std::vector<int32_t> zero_usage((size_t)N * F, 0);
    std::vector<int64_t> avail((size_t)N * F), potential((size_t)N * F);
    for (int n = 0; n < N; ++n)
        for (int f = 0; f < F; ++f) {
            avail[(size_t)n * F + f] = available(
                n, f, F, usage0, subtree, guaranteed, borrow_cap,
                has_blim, parent);
            potential[(size_t)n * F + f] = available(
                n, f, F, zero_usage.data(), subtree, guaranteed, borrow_cap,
                has_blim, parent);
        }

    for (int w = 0; w < W; ++w) {
        fit_slot_out[w] = -1;
        borrows_out[w] = 0;
        preempt_out[w] = 0;
        int cq = wl_cq[w];
        if (cq < 0) continue;
        bool any_preempt = false;
        for (int s = 0; s < S && fit_slot_out[w] < 0; ++s) {
            bool missing = false, all_fit = true, any_nofit = false,
                 slot_borrows = false;
            for (int r = 0; r < R; ++r) {
                int64_t req = wl_requests[(size_t)w * R + r];
                if (req <= 0) continue;               // not requested
                int f = slot_fr[((size_t)cq * S + s) * R + r];
                if (f < 0) { missing = true; break; } // resource not covered
                int64_t av = avail[(size_t)cq * F + f];
                int64_t pot = potential[(size_t)cq * F + f];
                int64_t nom = nominal_cq[(size_t)cq * F + f];
                int64_t use = usage0[(size_t)cq * F + f];
                int64_t sq = subtree[(size_t)cq * F + f];
                bool fit_r = req <= av;
                bool nofit_r = req > pot;
                bool preempt_capable_r =
                    (req <= nom) || cq_can_preempt_borrow[cq];
                if (!fit_r) all_fit = false;
                if (nofit_r || (!fit_r && !preempt_capable_r))
                    any_nofit = true;
                if (use + req > sq) slot_borrows = true;
            }
            bool valid = slot_valid[(size_t)cq * S + s] && !missing;
            bool fit = all_fit && valid;
            bool nofit = any_nofit || !valid;
            if (fit) {
                fit_slot_out[w] = s;
                borrows_out[w] = (slot_borrows && parent[cq] >= 0) ? 1 : 0;
            } else if (!nofit) {
                any_preempt = true;
            }
        }
        if (fit_slot_out[w] < 0 && any_preempt) preempt_out[w] = 1;
    }
}

// The sequential admit loop over `order` (ops/cycle.py admit_scan; the
// reference admit loop's fixed-assignment fits re-check + capacity
// reserves, scheduler.go:245,383-408).  Decisions are per-head
// (flavor-resource, amount) pairs — assignment.Usage, exactly what the
// reference re-checks.  Mutates a private copy of usage.
void admit_scan(
    int32_t N, int32_t F, int32_t C, int32_t K, int32_t W,
    const int32_t* usage0,        // [N,F]
    const int32_t* subtree,       // [N,F]
    const int32_t* guaranteed,    // [N,F]
    const int32_t* borrow_cap,    // [N,F]
    const uint8_t* has_blim,      // [N,F]
    const int32_t* parent,        // [N]
    const int32_t* nominal_cq,    // [C,F]
    const int32_t* npb_cq,        // [C,F] nominal+borrowingLimit
    const int32_t* wl_cq,         // [W]
    const int32_t* dec_fr,        // [W,K] F-index or -1
    const int32_t* dec_amt,       // [W,K]
    const uint8_t* fit_mask,      // [W]
    const int32_t* res_fr,        // [W,K]
    const int32_t* res_amt,       // [W,K]
    const uint8_t* res_mask,      // [W]
    const uint8_t* res_borrows,   // [W]
    const int32_t* order,         // [W] cycle order
    uint8_t* admitted_out) {      // [W]

    std::vector<int32_t> usage(usage0, usage0 + (size_t)N * F);
    std::vector<int> chain;

    auto add_chain = [&](int node, int f, int64_t val) {
        // addUsage bubbling (resource_node.go:123)
        int64_t carry = val;
        for (int cur = node; cur >= 0 && carry != 0; cur = parent[cur]) {
            int64_t u = usage[(size_t)cur * F + f];
            int64_t g = guaranteed[(size_t)cur * F + f];
            int64_t local_avail = std::max<int64_t>(0, g - u);
            usage[(size_t)cur * F + f] = (int32_t)(u + carry);
            carry = std::max<int64_t>(0, carry - local_avail);
        }
    };

    for (int w = 0; w < W; ++w) admitted_out[w] = 0;
    for (int oi = 0; oi < W; ++oi) {
        int wi = order[oi];
        if (wi < 0 || wi >= W) continue;
        int cq = wl_cq[wi];
        if (cq < 0) continue;

        // the entry's root→cq chain depends only on cq: collect once,
        // reuse across the K pairs (no per-pair allocation)
        chain.clear();
        for (int cur = cq; cur >= 0; cur = parent[cur]) chain.push_back(cur);

        // per-step int32 truncation bit-matches the jitted kernel's
        // int32 arithmetic (the packer's x64 headroom keeps real values
        // in range; parity, not extra range, is the contract here)
        auto avail_at = [&](int f) -> int32_t {
            int root = chain.back();
            int32_t a = (int32_t)((int64_t)subtree[(size_t)root * F + f]
                                  - usage[(size_t)root * F + f]);
            for (int i = (int)chain.size() - 2; i >= 0; --i) {
                int cur = chain[i];
                int64_t u = usage[(size_t)cur * F + f];
                int64_t g = guaranteed[(size_t)cur * F + f];
                int64_t parent_avail = a;
                if (has_blim[(size_t)cur * F + f]) {
                    int64_t used_in_parent = std::max<int64_t>(0, u - g);
                    int64_t blim_cap =
                        (int64_t)borrow_cap[(size_t)cur * F + f]
                        - used_in_parent;
                    parent_avail = std::min(blim_cap, parent_avail);
                }
                a = (int32_t)(std::max<int64_t>(0, g - u) + parent_avail);
            }
            return a;
        };

        if (fit_mask[wi]) {
            bool ok = true;
            for (int k = 0; k < K && ok; ++k) {
                int f = dec_fr[(size_t)wi * K + k];
                if (f < 0) continue;
                if (dec_amt[(size_t)wi * K + k] > avail_at(f)) ok = false;
            }
            if (ok) {
                admitted_out[wi] = 1;
                for (int k = 0; k < K; ++k) {
                    int f = dec_fr[(size_t)wi * K + k];
                    if (f >= 0)
                        add_chain(cq, f, dec_amt[(size_t)wi * K + k]);
                }
            }
        }
        if (res_mask[wi]) {
            // resourcesToReserve (scheduler.go:383-408)
            for (int k = 0; k < K; ++k) {
                int f = res_fr[(size_t)wi * K + k];
                if (f < 0) continue;
                int64_t amt = res_amt[(size_t)wi * K + k];
                int64_t cur = usage[(size_t)cq * F + f];
                int64_t rdelta;
                if (res_borrows[wi]) {
                    rdelta = std::min<int64_t>(
                        amt, (int64_t)npb_cq[(size_t)cq * F + f] - cur);
                } else {
                    rdelta = std::max<int64_t>(
                        0, std::min<int64_t>(
                            amt,
                            (int64_t)nominal_cq[(size_t)cq * F + f] - cur));
                }
                add_chain(cq, f, rdelta);
            }
        }
    }
}

}  // extern "C"
