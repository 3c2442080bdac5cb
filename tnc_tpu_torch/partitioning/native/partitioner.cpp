// Native multilevel hypergraph partitioner (KaHyPar-class).
//
// The reference links the KaHyPar C++ library for its partitioning step
// (tnc/src/tensornetwork/partitioning.rs:6,76-89). This is an original
// multilevel implementation of the same algorithm family — heavy-edge
// matching coarsening, BFS region-growing initial partitions, and
// Fiduccia–Mattheyses refinement at every uncoarsening level, with k-way
// via recursive bisection — exposed through a C ABI for ctypes.
//
// Deterministic for a fixed seed (own mt19937_64; no global state).

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <deque>
#include <queue>
#include <random>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Hypergraph {
    int n = 0;
    std::vector<double> vertex_weights;
    std::vector<std::vector<int>> edge_pins;
    std::vector<double> edge_weights;
    std::vector<std::vector<int>> vertex_edges;

    void build_incidence() {
        vertex_edges.assign(n, {});
        for (int e = 0; e < (int)edge_pins.size(); ++e)
            for (int v : edge_pins[e]) vertex_edges[v].push_back(e);
    }

    double total_vertex_weight() const {
        double s = 0;
        for (double w : vertex_weights) s += w;
        return s;
    }

    double cut_weight(const std::vector<int>& part) const {
        double cut = 0;
        for (int e = 0; e < (int)edge_pins.size(); ++e) {
            int first = part[edge_pins[e][0]];
            for (int v : edge_pins[e])
                if (part[v] != first) {
                    cut += edge_weights[e];
                    break;
                }
        }
        return cut;
    }
};

struct CoarseLevel {
    Hypergraph graph;
    std::vector<std::vector<int>> members;  // coarse vertex -> fine vertices
};

// One round of heavy-edge matching; false = no progress.
bool coarsen_once(const Hypergraph& hg, std::mt19937_64& rng, CoarseLevel& out) {
    const int n = hg.n;
    std::vector<int> order(n);
    for (int i = 0; i < n; ++i) order[i] = i;
    std::shuffle(order.begin(), order.end(), rng);

    std::vector<int> matched(n, -1);
    std::unordered_map<int, double> conn;
    for (int v : order) {
        if (matched[v] >= 0) continue;
        conn.clear();
        for (int e : hg.vertex_edges[v]) {
            const auto& pins = hg.edge_pins[e];
            if ((int)pins.size() > 8) continue;  // skip huge hyperedges
            double w = hg.edge_weights[e] / (double)(pins.size() - 1);
            for (int u : pins)
                if (u != v && matched[u] < 0) conn[u] += w;
        }
        int best_u = -1;
        double best_w = 0.0;
        for (const auto& [u, w] : conn)
            if (w > best_w || (w == best_w && best_u >= 0 && u < best_u)) {
                best_w = w;
                best_u = u;
            }
        if (best_u >= 0) {
            matched[v] = best_u;
            matched[best_u] = v;
        }
    }

    std::vector<int> coarse_id(n, -1);
    out.members.clear();
    for (int v = 0; v < n; ++v) {
        if (coarse_id[v] >= 0) continue;
        int u = matched[v];
        int cid = (int)out.members.size();
        if (u >= 0 && u != v) {
            out.members.push_back({v, u});
            coarse_id[v] = coarse_id[u] = cid;
        } else {
            out.members.push_back({v});
            coarse_id[v] = cid;
        }
    }
    if ((int)out.members.size() >= n) return false;

    Hypergraph& cg = out.graph;
    cg.n = (int)out.members.size();
    cg.vertex_weights.assign(cg.n, 0.0);
    for (int cid = 0; cid < cg.n; ++cid)
        for (int v : out.members[cid]) cg.vertex_weights[cid] += hg.vertex_weights[v];

    // merge parallel coarse hyperedges, keyed by sorted pin set
    std::unordered_map<std::string, int> edge_index;
    std::vector<int> cpins;
    for (int e = 0; e < (int)hg.edge_pins.size(); ++e) {
        cpins.clear();
        for (int v : hg.edge_pins[e]) cpins.push_back(coarse_id[v]);
        std::sort(cpins.begin(), cpins.end());
        cpins.erase(std::unique(cpins.begin(), cpins.end()), cpins.end());
        if ((int)cpins.size() < 2) continue;
        std::string key((const char*)cpins.data(), cpins.size() * sizeof(int));
        auto it = edge_index.find(key);
        if (it == edge_index.end()) {
            edge_index.emplace(std::move(key), (int)cg.edge_pins.size());
            cg.edge_pins.push_back(cpins);
            cg.edge_weights.push_back(hg.edge_weights[e]);
        } else {
            cg.edge_weights[it->second] += hg.edge_weights[e];
        }
    }
    cg.build_incidence();
    return true;
}

// BFS region growing from random seeds; best cut over `attempts` wins.
std::vector<int> initial_partition(const Hypergraph& hg, double target0,
                                   double imbalance, std::mt19937_64& rng,
                                   int attempts = 8) {
    std::vector<int> best;
    double best_cut = 1e300;
    const double max0 = target0 * (1.0 + imbalance);
    std::uniform_int_distribution<int> pick(0, hg.n - 1);
    for (int a = 0; a < std::max(1, attempts); ++a) {
        std::vector<int> part(hg.n, 1);
        int seed = pick(rng);
        double weight0 = 0.0;
        std::deque<int> frontier{seed};
        std::vector<char> seen(hg.n, 0);
        seen[seed] = 1;
        while (!frontier.empty() && weight0 < target0) {
            int v = frontier.back();
            frontier.pop_back();
            if (weight0 + hg.vertex_weights[v] > max0) continue;
            part[v] = 0;
            weight0 += hg.vertex_weights[v];
            for (int e : hg.vertex_edges[v])
                for (int u : hg.edge_pins[e])
                    if (!seen[u]) {
                        seen[u] = 1;
                        frontier.push_front(u);
                    }
        }
        double cut = hg.cut_weight(part);
        if (cut < best_cut) {
            best_cut = cut;
            best = part;
        }
    }
    return best;
}

// Fiduccia–Mattheyses boundary refinement, in place.
void fm_refine(const Hypergraph& hg, std::vector<int>& part, double target0,
               double imbalance, int max_passes = 8) {
    const int n = hg.n;
    const double total = hg.total_vertex_weight();
    const double min0 = target0 * (1.0 - imbalance);
    const double max0 = target0 * (1.0 + imbalance);

    std::vector<std::array<int, 2>> pins_in(hg.edge_pins.size());
    for (int pass = 0; pass < max_passes; ++pass) {
        for (int e = 0; e < (int)hg.edge_pins.size(); ++e) {
            pins_in[e] = {0, 0};
            for (int v : hg.edge_pins[e]) pins_in[e][part[v]]++;
        }
        double weight0 = 0.0;
        for (int v = 0; v < n; ++v)
            if (part[v] == 0) weight0 += hg.vertex_weights[v];

        auto gain = [&](int v) {
            double g = 0.0;
            int side = part[v], other = 1 - side;
            for (int e : hg.vertex_edges[v]) {
                if (pins_in[e][side] == 1) g += hg.edge_weights[e];
                if (pins_in[e][other] == 0) g -= hg.edge_weights[e];
            }
            return g;
        };

        // max-heap of (gain, vertex); lazy deletion via gain re-check
        std::priority_queue<std::pair<double, int>> heap;
        for (int v = 0; v < n; ++v) heap.push({gain(v), v});

        std::vector<char> locked(n, 0);
        std::vector<int> moves;
        double cum_gain = 0.0, best_gain = 0.0;
        size_t best_prefix = 0;

        while (!heap.empty()) {
            auto [g_stored, v] = heap.top();
            heap.pop();
            if (locked[v]) continue;
            double g = gain(v);
            if (g_stored != g) {  // stale entry: reinsert fresh
                heap.push({g, v});
                continue;
            }
            double w = hg.vertex_weights[v];
            double new_weight0 = part[v] == 0 ? weight0 - w : weight0 + w;
            if (!(min0 <= new_weight0 && new_weight0 <= max0) && total > w) {
                locked[v] = 1;
                continue;
            }
            int side = part[v];
            for (int e : hg.vertex_edges[v]) {
                pins_in[e][side]--;
                pins_in[e][1 - side]++;
            }
            part[v] = 1 - side;
            weight0 = new_weight0;
            locked[v] = 1;
            cum_gain += g;
            moves.push_back(v);
            if (cum_gain > best_gain + 1e-12) {
                best_gain = cum_gain;
                best_prefix = moves.size();
            }
            for (int e : hg.vertex_edges[v])
                for (int u : hg.edge_pins[e])
                    if (!locked[u]) heap.push({gain(u), u});
        }

        for (size_t i = best_prefix; i < moves.size(); ++i)
            part[moves[i]] = 1 - part[moves[i]];
        if (best_gain <= 1e-12) break;
    }
}

std::vector<int> bisect(const Hypergraph& hg, double imbalance,
                        std::mt19937_64& rng, double target_fraction = 0.5,
                        int coarsen_to = 80) {
    if (hg.n <= 1) return std::vector<int>(hg.n, 0);
    double target0 = hg.total_vertex_weight() * target_fraction;

    std::vector<CoarseLevel> levels;
    const Hypergraph* current = &hg;
    while (current->n > coarsen_to) {
        CoarseLevel level;
        if (!coarsen_once(*current, rng, level)) break;
        levels.push_back(std::move(level));
        current = &levels.back().graph;
    }

    std::vector<int> part = initial_partition(*current, target0, imbalance, rng);
    fm_refine(*current, part, target0, imbalance);

    for (int i = (int)levels.size() - 1; i >= 0; --i) {
        const Hypergraph& fine = i == 0 ? hg : levels[i - 1].graph;
        std::vector<int> fine_part(fine.n, 0);
        for (int cid = 0; cid < (int)levels[i].members.size(); ++cid)
            for (int v : levels[i].members[cid]) fine_part[v] = part[cid];
        part = std::move(fine_part);
        fm_refine(fine, part, target0, imbalance);
    }
    return part;
}

void partition_recurse(const Hypergraph& hg, const std::vector<int>& vertices,
                       int k_local, int base, double imbalance,
                       std::mt19937_64& rng, std::vector<int>& part) {
    if (k_local <= 1 || (int)vertices.size() <= 1) {
        for (int v : vertices) part[v] = base;
        return;
    }
    int k_left = k_local / 2;
    int k_right = k_local - k_left;

    std::vector<int> index(hg.n, -1);
    for (int i = 0; i < (int)vertices.size(); ++i) index[vertices[i]] = i;

    Hypergraph sub;
    sub.n = (int)vertices.size();
    sub.vertex_weights.reserve(sub.n);
    for (int v : vertices) sub.vertex_weights.push_back(hg.vertex_weights[v]);
    std::vector<int> sub_pins;
    for (int e = 0; e < (int)hg.edge_pins.size(); ++e) {
        sub_pins.clear();
        for (int v : hg.edge_pins[e])
            if (index[v] >= 0) sub_pins.push_back(index[v]);
        if ((int)sub_pins.size() >= 2) {
            sub.edge_pins.push_back(sub_pins);
            sub.edge_weights.push_back(hg.edge_weights[e]);
        }
    }
    sub.build_incidence();

    std::vector<int> sides =
        bisect(sub, imbalance, rng, (double)k_left / (double)k_local);
    std::vector<int> left, right;
    for (int i = 0; i < (int)vertices.size(); ++i)
        (sides[i] == 0 ? left : right).push_back(vertices[i]);
    if (left.empty() || right.empty()) {  // degenerate split: force non-empty
        left.clear();
        right.clear();
        size_t half = std::max<size_t>(
            1, vertices.size() * (size_t)k_left / (size_t)k_local);
        for (size_t i = 0; i < vertices.size(); ++i)
            (i < half ? left : right).push_back(vertices[i]);
    }
    partition_recurse(hg, left, k_left, base, imbalance, rng, part);
    partition_recurse(hg, right, k_right, base + k_left, imbalance, rng, part);
}

// Direct k-way move-based refinement under the connectivity (km1)
// objective: sum_e w_e * (lambda_e - 1), lambda_e = #blocks edge e
// touches. This is where the km1 preset genuinely diverges from
// cut-based recursive bisection — in any 2-way split lambda-1 equals
// the cut indicator, so only a k-way pass can tell them apart (the
// same reason KaHyPar ships cut and km1 as distinct configs,
// tnc/src/tensornetwork/partition_config.rs:12-36).
void kway_refine_km1(const Hypergraph& hg, std::vector<int>& part, int k,
                     double imbalance, int max_passes = 8) {
    const int n = hg.n;
    if (k <= 1 || n <= 1) return;
    const double target = hg.total_vertex_weight() / (double)k;
    const double maxb = target * (1.0 + imbalance);

    std::vector<std::vector<int>> pins_in(hg.edge_pins.size(),
                                          std::vector<int>(k, 0));
    for (int e = 0; e < (int)hg.edge_pins.size(); ++e)
        for (int v : hg.edge_pins[e]) pins_in[e][part[v]]++;
    std::vector<double> block_w(k, 0.0);
    for (int v = 0; v < n; ++v) block_w[part[v]] += hg.vertex_weights[v];

    std::vector<char> tried(k, 0);
    for (int pass = 0; pass < max_passes; ++pass) {
        bool moved = false;
        for (int v = 0; v < n; ++v) {
            const int a = part[v];
            // candidate target blocks: only blocks adjacent through v's
            // edges can have positive gain
            double remove_gain = 0.0;
            for (int e : hg.vertex_edges[v])
                if (pins_in[e][a] == 1) remove_gain += hg.edge_weights[e];
            int best_b = -1;
            double best_gain = 1e-12;
            std::fill(tried.begin(), tried.end(), 0);
            tried[a] = 1;
            for (int e : hg.vertex_edges[v]) {
                for (int u : hg.edge_pins[e]) {
                    int b = part[u];
                    if (tried[b]) continue;
                    tried[b] = 1;
                    double gain = remove_gain;
                    for (int e2 : hg.vertex_edges[v])
                        if (pins_in[e2][b] == 0) gain -= hg.edge_weights[e2];
                    if (gain > best_gain &&
                        block_w[b] + hg.vertex_weights[v] <= maxb) {
                        best_gain = gain;
                        best_b = b;
                    }
                }
            }
            if (best_b < 0) continue;
            for (int e : hg.vertex_edges[v]) {
                pins_in[e][a]--;
                pins_in[e][best_b]++;
            }
            block_w[a] -= hg.vertex_weights[v];
            block_w[best_b] += hg.vertex_weights[v];
            part[v] = best_b;
            moved = true;
        }
        if (!moved) break;
    }
}

double km1_weight(const Hypergraph& hg, const std::vector<int>& part, int k) {
    double total = 0.0;
    std::vector<char> seen(k, 0);
    for (int e = 0; e < (int)hg.edge_pins.size(); ++e) {
        std::fill(seen.begin(), seen.end(), 0);
        int lambda = 0;
        for (int v : hg.edge_pins[e])
            if (!seen[part[v]]) {
                seen[part[v]] = 1;
                ++lambda;
            }
        if (lambda > 1) total += hg.edge_weights[e] * (double)(lambda - 1);
    }
    return total;
}

Hypergraph hypergraph_from_csr(int num_vertices, const double* vertex_weights,
                               int num_edges, const int* edge_offsets,
                               const int* edge_pins,
                               const double* edge_weights, bool* ok) {
    Hypergraph hg;
    *ok = false;
    if (num_vertices < 0 || num_edges < 0) return hg;
    hg.n = num_vertices;
    hg.vertex_weights.assign(vertex_weights, vertex_weights + num_vertices);
    hg.edge_pins.resize(num_edges);
    hg.edge_weights.assign(edge_weights, edge_weights + num_edges);
    for (int e = 0; e < num_edges; ++e) {
        int beg = edge_offsets[e], end = edge_offsets[e + 1];
        if (beg > end) return hg;
        hg.edge_pins[e].assign(edge_pins + beg, edge_pins + end);
        for (int v : hg.edge_pins[e])
            if (v < 0 || v >= num_vertices) return hg;
    }
    hg.build_incidence();
    *ok = true;
    return hg;
}

}  // namespace

extern "C" {

// Partition a hypergraph (CSR pin lists) into k blocks. Returns 0 on
// success; out_partition[v] in [0, k).
int tnc_partition_kway(int num_vertices, const double* vertex_weights,
                       int num_edges, const int* edge_offsets,
                       const int* edge_pins, const double* edge_weights,
                       int k, double imbalance, uint64_t seed,
                       int* out_partition) {
    if (k <= 0) return 1;
    bool ok = false;
    Hypergraph hg = hypergraph_from_csr(num_vertices, vertex_weights,
                                        num_edges, edge_offsets, edge_pins,
                                        edge_weights, &ok);
    if (!ok) return 1;

    std::mt19937_64 rng(seed);
    std::vector<int> part(num_vertices, 0);
    if (k > 1) {
        std::vector<int> vertices(num_vertices);
        for (int i = 0; i < num_vertices; ++i) vertices[i] = i;
        partition_recurse(hg, vertices, k, 0, imbalance, rng, part);
    }
    std::memcpy(out_partition, part.data(), num_vertices * sizeof(int));
    return 0;
}

// Refine a k-way partition in place under the km1 (connectivity)
// objective. `partition` is read and overwritten.
int tnc_kway_refine_km1(int num_vertices, const double* vertex_weights,
                        int num_edges, const int* edge_offsets,
                        const int* edge_pins, const double* edge_weights,
                        int k, double imbalance, int max_passes,
                        int* partition) {
    if (k <= 0) return 1;
    bool ok = false;
    Hypergraph hg = hypergraph_from_csr(num_vertices, vertex_weights,
                                        num_edges, edge_offsets, edge_pins,
                                        edge_weights, &ok);
    if (!ok) return 1;
    std::vector<int> part(partition, partition + num_vertices);
    for (int v : part)
        if (v < 0 || v >= k) return 1;
    kway_refine_km1(hg, part, k, imbalance, max_passes);
    std::memcpy(partition, part.data(), num_vertices * sizeof(int));
    return 0;
}

// km1 (connectivity) metric of a partition: sum_e w_e * (lambda_e - 1).
double tnc_km1_weight(int num_vertices, int num_edges,
                      const int* edge_offsets, const int* edge_pins,
                      const double* edge_weights, int k,
                      const int* partition) {
    bool ok = false;
    std::vector<double> unit(num_vertices, 1.0);
    Hypergraph hg = hypergraph_from_csr(num_vertices, unit.data(), num_edges,
                                        edge_offsets, edge_pins, edge_weights,
                                        &ok);
    if (!ok || k <= 0) return -1.0;
    std::vector<int> part(partition, partition + num_vertices);
    for (int v : part)
        if (v < 0 || v >= k) return -1.0;  // would index past seen[k]
    return km1_weight(hg, part, k);
}

// Cut weight of a given partition (for tests/diagnostics).
double tnc_cut_weight(int num_vertices, int num_edges, const int* edge_offsets,
                      const int* edge_pins, const double* edge_weights,
                      const int* partition) {
    double cut = 0.0;
    for (int e = 0; e < num_edges; ++e) {
        int beg = edge_offsets[e], end = edge_offsets[e + 1];
        if (end - beg < 2) continue;
        int first = partition[edge_pins[beg]];
        for (int i = beg + 1; i < end; ++i)
            if (partition[edge_pins[i]] != first) {
                cut += edge_weights[e];
                break;
            }
    }
    return cut;
}

}  // extern "C"
