// Native sliced-path replay — the planner's hottest loop.
//
// Slicing-aware candidate scoring replays a contraction path once per
// candidate leg with that leg's dimension pinned to 1
// (contractionpath/slicing.py::_replay_sizes/_reduced_flops). In Python
// this builds millions of throwaway LeafTensors (96% of north-star
// planning time, ~230 s of 240 s profiled); here a replay is a few
// hundred bitset XORs. Leg sets are bitmasks over dense leg indices
// (n_words x u64, same shape discipline as treedp.cpp); sizes are
// 2^(sum of log2 dims over set bits), matching the Python cost model
// exactly (it computes in float products of power-of-two dims).
//
// Exposed through the same ctypes binding as the partitioner.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

inline double mask_log2size(const uint64_t* mask, int n_words,
                            const double* log2dims) {
    double s = 0.0;
    for (int w = 0; w < n_words; ++w) {
        uint64_t bits = mask[w];
        while (bits) {
            int b = __builtin_ctzll(bits);
            s += log2dims[w * 64 + b];
            bits &= bits - 1;
        }
    }
    return s;
}

}  // namespace

extern "C" {

// Replay a flat replace-format path over bitmask leg sets with
// `removed_mask` legs deleted everywhere.
//
//   leaf_masks: n_leaves * n_words u64, leg bit i set = tensor has leg i
//   log2dims:   n_words*64 doubles (log2 of each leg's dim; 0 padding)
//   pairs:      2*n_steps ints, replace-left (result overwrites slot i)
//   out_peak:   max over steps of (|out| + |in1| + |in2|) in elements
//   out_flops:  sum over steps of |in1 UNION in2| in elements
//   out_leg_peak: if non-null, n_words*64 doubles — for every leg, the
//                 largest step size any tensor holding it participated
//                 in (0 = never seen); mirrors _replay_sizes' map.
//
// Returns 0 on success, 1 on malformed input.
int tnc_sliced_replay(int n_leaves, int n_words, const uint64_t* leaf_masks,
                      const double* log2dims, int n_steps, const int* pairs,
                      const uint64_t* removed_mask, double* out_peak,
                      double* out_flops, double* out_leg_peak) {
    if (n_leaves <= 0 || n_words <= 0 || n_steps < 0) return 1;
    std::vector<uint64_t> masks((size_t)n_leaves * n_words);
    for (int t = 0; t < n_leaves; ++t)
        for (int w = 0; w < n_words; ++w)
            masks[(size_t)t * n_words + w] =
                leaf_masks[(size_t)t * n_words + w] & ~removed_mask[w];

    std::vector<double> log2size(n_leaves);
    for (int t = 0; t < n_leaves; ++t)
        log2size[t] =
            mask_log2size(&masks[(size_t)t * n_words], n_words, log2dims);

    if (out_leg_peak)
        for (int i = 0; i < n_words * 64; ++i) out_leg_peak[i] = 0.0;

    double peak = 0.0, flops = 0.0;
    std::vector<uint64_t> un(n_words);
    for (int s = 0; s < n_steps; ++s) {
        int i = pairs[2 * s], j = pairs[2 * s + 1];
        if (i < 0 || i >= n_leaves || j < 0 || j >= n_leaves || i == j)
            return 1;
        uint64_t* mi = &masks[(size_t)i * n_words];
        uint64_t* mj = &masks[(size_t)j * n_words];
        for (int w = 0; w < n_words; ++w) un[w] = mi[w] | mj[w];
        double lun = mask_log2size(un.data(), n_words, log2dims);
        flops += std::exp2(lun);
        // out = i ^ j; contracted legs are in both (i & j)
        double lshared = 0.0;
        for (int w = 0; w < n_words; ++w) {
            uint64_t shared = mi[w] & mj[w];
            while (shared) {
                int b = __builtin_ctzll(shared);
                lshared += log2dims[w * 64 + b];
                shared &= shared - 1;
            }
        }
        double lout = lun - lshared;  // xor = union minus shared legs
        double step = std::exp2(lout) + std::exp2(log2size[i]) +
                      std::exp2(log2size[j]);
        if (step > peak) peak = step;
        if (out_leg_peak) {
            // legs of in1, in2, out are all subsets of the union
            for (int w = 0; w < n_words; ++w) {
                uint64_t bits = un[w];
                while (bits) {
                    int b = __builtin_ctzll(bits);
                    int leg = w * 64 + b;
                    if (step > out_leg_peak[leg]) out_leg_peak[leg] = step;
                    bits &= bits - 1;
                }
            }
        }
        for (int w = 0; w < n_words; ++w) mi[w] ^= mj[w];
        log2size[i] = lout;
        // slot j is consumed (replace-left); leave its mask, it is
        // never referenced again on a valid path
    }
    *out_peak = peak;
    *out_flops = flops;
    return 0;
}

}  // extern "C"
