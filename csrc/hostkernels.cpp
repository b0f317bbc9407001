// Native host kernels for the input pipeline.
//
// The reference delegates its host-side hot loops to numba JIT kernels and
// DGL's C++ samplers (SURVEY §2.3): subisomorphism weight counting
// (SubgraphCountingMatching/dataset.py:22-108), nid remapping, and the UNC
// neighbor/random-walk samplers (UnsupervisedNodeClassification/Model/DMPNN/
// src/utils.py:279-349). This library is the from-scratch C++ equivalent,
// exposed to Python via ctypes (dualmessagepassing_tpu/native.py) with
// numpy fallbacks when the shared object is unavailable.
//
// Build:  g++ -O3 -shared -fPIC -o libhostkernels.so hostkernels.cpp
// (done automatically on first import by native.py)

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

typedef int64_t i64;

// ---------------------------------------------------------------------------
// xorshift RNG (deterministic given seed)
// ---------------------------------------------------------------------------
static inline uint64_t xorshift(uint64_t* s) {
    uint64_t x = *s;
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    return *s = x;
}

// ---------------------------------------------------------------------------
// subgraph isomorphism enumeration (backtracking)
//
// Injective node mapping m with label preservation and every pattern edge
// (u, v, el) matched by a graph edge (m(u), m(v), el). Returns the number
// of mappings found (capped at max_count); writes them row-major into
// out_mappings (n_found x n_p) when non-null.
// ---------------------------------------------------------------------------
i64 enumerate_subiso(
    i64 n_p, i64 n_g,
    i64 n_pe, const i64* p_src, const i64* p_dst, const i64* p_el,
    i64 n_ge, const i64* g_src, const i64* g_dst, const i64* g_el,
    const i64* p_vl, const i64* g_vl,
    i64 max_count, i64* out_mappings)
{
    // sort graph edges by (src, dst) key for binary search
    std::vector<i64> order(n_ge);
    for (i64 i = 0; i < n_ge; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](i64 a, i64 b) {
        if (g_src[a] != g_src[b]) return g_src[a] < g_src[b];
        return g_dst[a] < g_dst[b];
    });
    std::vector<i64> key(n_ge), lab(n_ge);
    for (i64 i = 0; i < n_ge; ++i) {
        key[i] = g_src[order[i]] * n_g + g_dst[order[i]];
        lab[i] = g_el[order[i]];
    }

    auto has_edge = [&](i64 u, i64 v, i64 l) -> bool {
        i64 k = u * n_g + v;
        auto it = std::lower_bound(key.begin(), key.end(), k);
        for (; it != key.end() && *it == k; ++it)
            if (lab[it - key.begin()] == l) return true;
        return false;
    };

    // pattern constraints among already-mapped nodes: for node i, edges to
    // nodes j < i (direction 0: i->j, 1: j->i)
    struct Con { i64 nbr, el, dir; };
    std::vector<std::vector<Con>> cons(n_p);
    for (i64 e = 0; e < n_pe; ++e) {
        i64 s = p_src[e], d = p_dst[e], l = p_el[e];
        if (s > d) cons[s].push_back({d, l, 0});
        else if (d > s) cons[d].push_back({s, l, 1});
        else cons[s].push_back({s, l, 0}); // self loop: checked when s maps
    }

    std::vector<i64> mapping(n_p, -1);
    std::vector<char> used(n_g, 0);
    i64 found = 0;

    // iterative backtracking
    std::vector<i64> cand(n_p, 0);
    i64 depth = 0;
    while (depth >= 0) {
        if (depth == n_p) {
            if (out_mappings && found < max_count)
                std::memcpy(out_mappings + found * n_p, mapping.data(),
                            n_p * sizeof(i64));
            ++found;
            if (found >= max_count) break;
            --depth;
            continue;
        }
        // resuming this depth: release any previous assignment first
        if (mapping[depth] >= 0) {
            used[mapping[depth]] = 0;
            mapping[depth] = -1;
        }
        bool advanced = false;
        for (i64 g = cand[depth]; g < n_g; ++g) {
            if (used[g] || g_vl[g] != p_vl[depth]) continue;
            bool ok = true;
            for (const Con& c : cons[depth]) {
                i64 m = (c.nbr == depth) ? g : mapping[c.nbr];
                i64 u = c.dir == 0 ? g : m;
                i64 v = c.dir == 0 ? m : g;
                if (!has_edge(u, v, c.el)) { ok = false; break; }
            }
            if (!ok) continue;
            mapping[depth] = g;
            used[g] = 1;
            cand[depth] = g + 1;
            ++depth;
            if (depth < n_p) cand[depth] = 0;
            advanced = true;
            break;
        }
        if (!advanced) {
            cand[depth] = 0;
            --depth;
        }
    }
    // unwind any used flags (safety: state is local, nothing else to do)
    return found;
}

// ---------------------------------------------------------------------------
// per-edge subisomorphism weights
// (reference compute_edgeseq_subisoweights semantics on (src,dst,label) keys)
// ---------------------------------------------------------------------------
void edge_subiso_weights(
    i64 n_pe, const i64* p_src, const i64* p_dst, const i64* p_el,
    i64 n_ge, const i64* g_src, const i64* g_dst, const i64* g_el, i64 n_g,
    i64 n_iso, i64 n_p, const i64* mappings,
    i64* out_weights)
{
    std::vector<i64> order(n_ge);
    for (i64 i = 0; i < n_ge; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](i64 a, i64 b) {
        if (g_src[a] != g_src[b]) return g_src[a] < g_src[b];
        return g_dst[a] < g_dst[b];
    });
    std::vector<i64> key(n_ge);
    for (i64 i = 0; i < n_ge; ++i)
        key[i] = g_src[order[i]] * n_g + g_dst[order[i]];

    std::memset(out_weights, 0, n_ge * sizeof(i64));
    for (i64 m = 0; m < n_iso; ++m) {
        const i64* map = mappings + m * n_p;
        for (i64 e = 0; e < n_pe; ++e) {
            i64 u = map[p_src[e]], v = map[p_dst[e]], l = p_el[e];
            i64 k = u * n_g + v;
            auto it = std::lower_bound(key.begin(), key.end(), k);
            for (; it != key.end() && *it == k; ++it) {
                i64 ge = order[it - key.begin()];
                if (g_el[ge] == l) out_weights[ge] += 1;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// UNC: sample <= width in-edges per node, uniform without replacement
// (dgl.sampling.sample_neighbors semantics). in_ptr/in_order are the
// destination-CSR of the whole graph. Returns total sampled count;
// out_eids must have room for n_nodes * width entries.
// ---------------------------------------------------------------------------
i64 sample_in_edges(
    const i64* in_ptr, const i64* in_order,
    i64 n_sel, const i64* nodes, i64 width, uint64_t seed,
    i64* out_eids)
{
    uint64_t s = seed * 2654435761ULL + 1442695040888963407ULL;
    i64 total = 0;
    std::vector<i64> buf;
    for (i64 i = 0; i < n_sel; ++i) {
        i64 v = nodes[i];
        i64 lo = in_ptr[v], hi = in_ptr[v + 1];
        i64 deg = hi - lo;
        if (deg <= width) {
            for (i64 j = lo; j < hi; ++j) out_eids[total++] = in_order[j];
        } else {
            // partial Fisher-Yates over a scratch copy
            buf.assign(in_order + lo, in_order + hi);
            for (i64 j = 0; j < width; ++j) {
                i64 r = j + (i64)(xorshift(&s) % (uint64_t)(deg - j));
                std::swap(buf[j], buf[r]);
                out_eids[total++] = buf[j];
            }
        }
    }
    return total;
}

// ---------------------------------------------------------------------------
// UNC: random walks over out-CSR; one walk of length depth per seed per
// repetition. Visited nodes written as -1-padded rows
// [n_seeds * (depth + 1)] per repetition block, repetitions stacked.
// ---------------------------------------------------------------------------
void random_walks(
    const i64* out_ptr, const i64* out_order_dst,
    i64 n_seeds, const i64* seeds, i64 depth, i64 reps, uint64_t seed,
    i64* out_nodes)
{
    uint64_t s = seed * 6364136223846793005ULL + 1442695040888963407ULL;
    i64 row_len = depth + 1;
    for (i64 rep = 0; rep < reps; ++rep) {
        for (i64 i = 0; i < n_seeds; ++i) {
            i64* row = out_nodes + (rep * n_seeds + i) * row_len;
            i64 cur = seeds[i];
            row[0] = cur;
            for (i64 st = 1; st < row_len; ++st) {
                i64 lo = out_ptr[cur], hi = out_ptr[cur + 1];
                if (hi <= lo) { for (; st < row_len; ++st) row[st] = -1; break; }
                cur = out_order_dst[lo + (i64)(xorshift(&s)
                                               % (uint64_t)(hi - lo))];
                row[st] = cur;
            }
        }
    }
}

}  // extern "C"
