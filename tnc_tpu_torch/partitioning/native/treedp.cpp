// Exact subset-DP contraction ordering over a small tensor frontier.
//
// Native engine behind ContractionTree.reconfigure (the framework's
// equivalent of the reference's cotengra subtree_reconfigure bridge,
// tnc/src/contractionpath/paths/tree_reconfiguration.rs:54-56). The DP is
// the standard optimal-einsum recurrence over vertex subsets; legs are bit
// positions in multi-word masks and a leg appears in at most two tensors,
// so the result legs of any subset are the XOR of its leaf masks.
//
// Key identity making the inner loop O(1): with la = log2 size(sub),
// lb = log2 size(rest), lm = log2 size(sub XOR rest) all precomputed per
// mask, the contraction's op count (product of union dims) is
//   2^((la + lb + lm) / 2)
// because union = xor + shared, and shared contributes (la+lb-lm)/2.
//
// Exposed via ctypes from tnc_tpu/partitioning/native_binding.py; built
// together with partitioner.cpp into one shared library.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Sum of logdims over the set bits of a multi-word mask, via per-byte
// lookup tables built once per call.
struct ByteTables {
    // tables[byte_position][byte_value]
    std::vector<double> flat;  // (nwords*8) * 256
    int nwords;

    ByteTables(int nlegs, int nwords_, const double* leg_logdims)
        : flat(static_cast<size_t>(nwords_) * 8 * 256, 0.0), nwords(nwords_) {
        for (int pos = 0; pos < nwords * 8; ++pos) {
            double* table = &flat[static_cast<size_t>(pos) * 256];
            for (int value = 1; value < 256; ++value) {
                int low = value & (value - 1);
                int bit = __builtin_ctz(value);
                int leg = pos * 8 + bit;
                table[value] =
                    table[low] + (leg < nlegs ? leg_logdims[leg] : 0.0);
            }
        }
    }

    double logsize(const uint64_t* mask) const {
        double total = 0.0;
        for (int w = 0; w < nwords; ++w) {
            uint64_t word = mask[w];
            const double* base = &flat[static_cast<size_t>(w) * 8 * 256];
            for (int b = 0; b < 8 && word; ++b) {
                total += base[static_cast<size_t>(b) * 256 + (word & 0xff)];
                word >>= 8;
            }
        }
        return total;
    }
};

}  // namespace

extern "C" {

// Returns 0 on success, nonzero on invalid input. minimize: 0 = flops
// (sum of op counts), 1 = size (max intermediate element count).
// logsize_cap: if >= 0, any non-root intermediate with log2(size) >
// logsize_cap is forbidden (used by slice-aware reconfiguration);
// returns 1 if no ordering satisfies the cap.
// n is capped at 16: the subset DP is Theta(3^n) with no interruption
// point, so n=17..20 could stall a caller minutes past its time budget
// in a single uninterruptible solve (3^20 ~ 3.5e9 iterations).
int tnc_optimal_order(int n, int nlegs, const uint64_t* leaf_masks,
                      const double* leg_logdims, int minimize,
                      double logsize_cap, double* out_cost, int* out_pairs) {
    if (n < 2 || n > 16 || nlegs < 0) return 2;
    const int nwords = (nlegs + 63) / 64;
    if (nwords == 0) return 2;
    const uint32_t full = (n == 32) ? 0xffffffffu : ((1u << n) - 1);
    const size_t nmasks = static_cast<size_t>(full) + 1;

    ByteTables tables(nlegs, nwords, leg_logdims);

    // legs_of[mask] = XOR of member leaf masks; logsize[mask] alongside.
    std::vector<uint64_t> legs_of(nmasks * nwords, 0);
    std::vector<double> logsize(nmasks, 0.0);
    for (uint32_t mask = 1; mask <= full; ++mask) {
        uint32_t low = mask & (-mask);
        int leaf = __builtin_ctz(mask);
        const uint64_t* prev = &legs_of[static_cast<size_t>(mask ^ low) * nwords];
        const uint64_t* leaf_mask = &leaf_masks[static_cast<size_t>(leaf) * nwords];
        uint64_t* cur = &legs_of[static_cast<size_t>(mask) * nwords];
        for (int w = 0; w < nwords; ++w) cur[w] = prev[w] ^ leaf_mask[w];
        logsize[mask] = tables.logsize(cur);
    }

    const double inf = HUGE_VAL;
    std::vector<double> best(nmasks, inf);
    std::vector<uint32_t> split(nmasks, 0);
    for (int i = 0; i < n; ++i) best[1u << i] = 0.0;

    // Masks grouped by popcount so smaller subproblems are ready first.
    std::vector<std::vector<uint32_t>> by_count(n + 1);
    for (uint32_t mask = 1; mask <= full; ++mask)
        by_count[__builtin_popcount(mask)].push_back(mask);

    const bool by_size = minimize == 1;
    for (int count = 2; count <= n; ++count) {
        for (uint32_t mask : by_count[count]) {
            if (logsize_cap >= 0.0 && mask != full &&
                logsize[mask] > logsize_cap) {
                continue;  // intermediate too large under the cap
            }
            const uint32_t lowest = mask & (-mask);
            const double lm = logsize[mask];
            double best_cost = inf;
            uint32_t best_split = 0;
            // Enumerate submasks containing the lowest bit (canonical side).
            for (uint32_t sub = (mask - 1) & mask; sub; sub = (sub - 1) & mask) {
                if (!(sub & lowest)) continue;
                const uint32_t hi = mask ^ sub;
                const double c_lo = best[sub];
                const double c_hi = best[hi];
                if (c_lo == inf || c_hi == inf) continue;
                double cost;
                if (by_size) {
                    double out = exp2(lm);
                    cost = c_lo > c_hi ? c_lo : c_hi;
                    if (out > cost) cost = out;
                } else {
                    cost = c_lo + c_hi +
                           exp2(0.5 * (logsize[sub] + logsize[hi] + lm));
                }
                if (cost < best_cost) {
                    best_cost = cost;
                    best_split = sub;
                }
            }
            best[mask] = best_cost;
            split[mask] = best_split;
        }
    }
    if (best[full] == inf) return 1;

    // Reconstruct local SSA pairs (post-order, children before parents).
    int next_local = n;
    int out_idx = 0;
    // Iterative post-order: stack of (mask, stage).
    std::vector<std::pair<uint32_t, int>> stack;
    std::vector<int> node_of(nmasks, -1);
    stack.push_back({full, 0});
    while (!stack.empty()) {
        auto [mask, stage] = stack.back();
        stack.pop_back();
        if (__builtin_popcount(mask) == 1) {
            node_of[mask] = __builtin_ctz(mask);
            continue;
        }
        if (stage == 0) {
            stack.push_back({mask, 1});
            stack.push_back({split[mask], 0});
            stack.push_back({mask ^ split[mask], 0});
        } else {
            uint32_t lo = split[mask];
            out_pairs[out_idx * 2] = node_of[lo];
            out_pairs[out_idx * 2 + 1] = node_of[mask ^ lo];
            node_of[mask] = next_local++;
            ++out_idx;
        }
    }
    *out_cost = best[full];
    return 0;
}

}  // extern "C"
