// Native symbolic-analysis engine for russell_tpu.
//
// Reference role: the host-side analysis the reference delegates to native
// code (MUMPS JOB_ANALYZE in interface_mumps.c:95-164, UMFPACK
// umfpack_di_symbolic in interface_umfpack.c:109). The device numeric
// phases stay in XLA/Pallas; this module accelerates the host planning:
//
//  - rcm_order:     reverse Cuthill-McKee bandwidth reduction
//  - mindeg_order:  greedy minimum-degree fill-reducing ordering
//                   (quotient-graph clique formation)
//  - block_fill:    symbolic block right-looking LU fill enumeration
//                   (drives the SPLU static schedule)
//
// Exported with a plain C ABI for ctypes (no pybind11 in the image).
// Python fallbacks with identical contracts live in sparse/ordering.py
// and sparse/splu.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <set>
#include <vector>

extern "C" {

// Build a symmetrized CSR adjacency (no self loops). Returns nnz written.
static void symmetrize(int64_t n, int64_t nnz, const int64_t* rows,
                       const int64_t* cols,
                       std::vector<int64_t>& indptr,
                       std::vector<int64_t>& adj) {
    std::vector<std::vector<int64_t>> nb(n);
    for (int64_t k = 0; k < nnz; k++) {
        int64_t i = rows[k], j = cols[k];
        if (i == j) continue;
        nb[i].push_back(j);
        nb[j].push_back(i);
    }
    indptr.assign(n + 1, 0);
    for (int64_t i = 0; i < n; i++) {
        auto& v = nb[i];
        std::sort(v.begin(), v.end());
        v.erase(std::unique(v.begin(), v.end()), v.end());
        indptr[i + 1] = indptr[i] + (int64_t)v.size();
    }
    adj.resize(indptr[n]);
    for (int64_t i = 0; i < n; i++)
        std::copy(nb[i].begin(), nb[i].end(), adj.begin() + indptr[i]);
}

// Reverse Cuthill-McKee. out_order[k] = old index at position k (already
// reversed, matching sparse/ordering.py rcm_ordering).
int rcm_order(int64_t n, int64_t nnz, const int64_t* rows,
              const int64_t* cols, int64_t* out_order) {
    std::vector<int64_t> indptr, adj;
    symmetrize(n, nnz, rows, cols, indptr, adj);
    std::vector<int64_t> degree(n);
    for (int64_t i = 0; i < n; i++) degree[i] = indptr[i + 1] - indptr[i];
    std::vector<char> visited(n, 0);
    std::vector<int64_t> order;
    order.reserve(n);
    // candidates sorted by degree (stable)
    std::vector<int64_t> remaining(n);
    for (int64_t i = 0; i < n; i++) remaining[i] = i;
    std::stable_sort(remaining.begin(), remaining.end(),
                     [&](int64_t a, int64_t b) {
                         return degree[a] < degree[b];
                     });
    size_t rem_idx = 0;
    std::vector<int64_t> nbrs;
    while ((int64_t)order.size() < n) {
        while (rem_idx < remaining.size() && visited[remaining[rem_idx]])
            rem_idx++;
        int64_t start = remaining[rem_idx];
        visited[start] = 1;
        order.push_back(start);
        size_t head = order.size() - 1;
        while (head < order.size()) {
            int64_t u = order[head++];
            nbrs.clear();
            for (int64_t p = indptr[u]; p < indptr[u + 1]; p++) {
                int64_t w = adj[p];
                if (!visited[w]) nbrs.push_back(w);
            }
            std::stable_sort(nbrs.begin(), nbrs.end(),
                             [&](int64_t a, int64_t b) {
                                 return degree[a] < degree[b];
                             });
            for (int64_t w : nbrs) {
                visited[w] = 1;
                order.push_back(w);
            }
        }
    }
    for (int64_t k = 0; k < n; k++) out_order[k] = order[n - 1 - k];
    return 0;
}

// Greedy minimum-degree ordering (clique formation on elimination), the
// same contract as sparse/ordering.py mindeg_ordering: out_perm[k] = old
// index eliminated k-th.
int mindeg_order(int64_t n, int64_t nnz, const int64_t* rows,
                 const int64_t* cols, int64_t* out_perm) {
    std::vector<int64_t> indptr, adj;
    symmetrize(n, nnz, rows, cols, indptr, adj);
    std::vector<std::set<int64_t>> nb(n);
    for (int64_t i = 0; i < n; i++)
        nb[i] = std::set<int64_t>(adj.begin() + indptr[i],
                                  adj.begin() + indptr[i + 1]);
    std::vector<char> eliminated(n, 0);
    using QE = std::pair<int64_t, int64_t>;  // (degree, vertex)
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> heap;
    for (int64_t i = 0; i < n; i++) heap.push({(int64_t)nb[i].size(), i});
    std::vector<int64_t> live;
    for (int64_t k = 0; k < n; k++) {
        int64_t v = -1;
        while (true) {
            QE top = heap.top();
            heap.pop();
            if (!eliminated[top.second] &&
                top.first == (int64_t)nb[top.second].size()) {
                v = top.second;
                break;
            }
        }
        out_perm[k] = v;
        eliminated[v] = 1;
        live.clear();
        for (int64_t u : nb[v])
            if (!eliminated[u]) live.push_back(u);
        for (int64_t u : live) {
            auto& s = nb[u];
            s.erase(v);
            for (int64_t w : live)
                if (w != u) s.insert(w);
            heap.push({(int64_t)s.size(), u});
        }
        nb[v].clear();
    }
    return 0;
}

// Nested dissection: recursive BFS-level bisection, boundary level as
// separator; leaves first, separators last (sparse/ordering.py
// nd_ordering contract). out_order[k] = old index eliminated k-th.
// out_regions (capacity n) receives the size of each emitted region
// (leaf or separator, in emission order); *out_nregions the count. Both
// may be null.
int nd_order(int64_t n, int64_t nnz, const int64_t* rows,
             const int64_t* cols, int64_t leaf, int64_t* out_order,
             int64_t* out_regions, int64_t* out_nregions) {
    std::vector<int64_t> indptr, adj;
    symmetrize(n, nnz, rows, cols, indptr, adj);
    std::vector<int64_t> level(n, -1);
    std::vector<char> inset(n, 0);
    std::vector<int64_t> frontier, nxt;
    int64_t pos = 0;
    if (out_nregions) *out_nregions = 0;

    struct Task {
        std::vector<int64_t> verts;
        bool is_sep;  // emit verts directly (separator / leaf)
    };
    std::vector<Task> stack;
    {
        Task root;
        root.verts.resize(n);
        for (int64_t i = 0; i < n; i++) root.verts[i] = i;
        root.is_sep = false;
        stack.push_back(std::move(root));
    }
    while (!stack.empty()) {
        Task t = std::move(stack.back());
        stack.pop_back();
        auto& verts = t.verts;
        if (t.is_sep || (int64_t)verts.size() <= leaf) {
            if (out_regions && !verts.empty())
                out_regions[(*out_nregions)++] = (int64_t)verts.size();
            for (int64_t v : verts) out_order[pos++] = v;
            continue;
        }
        // BFS levels with a pseudo-peripheral start (two sweeps)
        for (int64_t v : verts) inset[v] = 1;
        int64_t start = verts[0];
        int64_t best_deg = INT64_MAX;
        for (int64_t v : verts) {
            int64_t d = indptr[v + 1] - indptr[v];
            if (d < best_deg) { best_deg = d; start = v; }
        }
        for (int sweep = 0; sweep < 2; sweep++) {
            for (int64_t v : verts) level[v] = -1;
            level[start] = 0;
            frontier.assign(1, start);
            int64_t last = start;
            while (!frontier.empty()) {
                nxt.clear();
                for (int64_t u : frontier) {
                    for (int64_t p = indptr[u]; p < indptr[u + 1]; p++) {
                        int64_t w = adj[p];
                        if (inset[w] && level[w] < 0) {
                            level[w] = level[u] + 1;
                            nxt.push_back(w);
                        }
                    }
                }
                if (!nxt.empty()) last = nxt.back();
                frontier.swap(nxt);
            }
            start = last;
        }
        int64_t maxlev = 0;
        int64_t nreach = 0;
        for (int64_t v : verts)
            if (level[v] >= 0) { nreach++; if (level[v] > maxlev) maxlev = level[v]; }
        if (maxlev < 2) {
            int64_t nreach2 = 0;
            for (int64_t v : verts) if (level[v] >= 0) nreach2++;
            if (nreach2 < (int64_t)verts.size()) {
                // disconnected region: recurse per component, no separator
                Task R, U;
                R.is_sep = U.is_sep = false;
                for (int64_t v : verts) {
                    inset[v] = 0;
                    if (level[v] >= 0) R.verts.push_back(v);
                    else U.verts.push_back(v);
                }
                stack.push_back(std::move(U));
                stack.push_back(std::move(R));
                continue;
            }
            // connected, diameter < 2: emit as a leaf
            if (out_regions && !verts.empty())
                out_regions[(*out_nregions)++] = (int64_t)verts.size();
            for (int64_t v : verts) { inset[v] = 0; out_order[pos++] = v; }
            continue;
        }
        // split at the median level
        std::vector<int64_t> counts(maxlev + 1, 0);
        for (int64_t v : verts) if (level[v] >= 0) counts[level[v]]++;
        int64_t half = 1, acc = 0;
        for (int64_t l = 0; l <= maxlev; l++) {
            acc += counts[l];
            if (acc >= nreach / 2) { half = l; break; }
        }
        if (half < 1) half = 1;
        if (half > maxlev - 1) half = maxlev - 1;
        Task A, B, S;
        A.is_sep = B.is_sep = false;
        S.is_sep = true;
        for (int64_t v : verts) {
            inset[v] = 0;
            if (level[v] < 0) B.verts.push_back(v);         // other components
            else if (level[v] < half) A.verts.push_back(v);
            else if (level[v] == half) S.verts.push_back(v);
            else B.verts.push_back(v);
        }
        stack.push_back(std::move(S));   // pops last -> emitted after A, B
        if (!B.verts.empty()) stack.push_back(std::move(B));
        if (!A.verts.empty()) stack.push_back(std::move(A));
    }
    return pos == n ? 0 : -1;
}

// Symbolic block right-looking LU fill (sparse/splu.py contract).
// Input: block pattern as nbp (bi, bj) pairs over nb block rows.
// Output: fills out_pairs (capacity cap, as i*nb+j codes) with the FINAL
// pattern including fill; returns the number of pairs, or -1 if cap is
// too small.
int64_t block_fill(int64_t nb, int64_t nbp, const int64_t* bi,
                   const int64_t* bj, int64_t cap, int64_t* out_pairs) {
    std::vector<std::set<int64_t>> lower(nb), upper(nb);
    std::set<int64_t> pat;
    for (int64_t k = 0; k < nbp; k++) {
        int64_t i = bi[k], j = bj[k];
        pat.insert(i * nb + j);
    }
    for (int64_t k = 0; k < nb; k++) pat.insert(k * nb + k);
    for (int64_t code : pat) {
        int64_t i = code / nb, j = code % nb;
        if (i > j) lower[j].insert(i);
        else if (i < j) upper[i].insert(j);
    }
    for (int64_t k = 0; k < nb; k++) {
        std::vector<int64_t> Ls(lower[k].begin(), lower[k].end());
        std::vector<int64_t> Us(upper[k].begin(), upper[k].end());
        for (int64_t i : Ls) {
            for (int64_t j : Us) {
                int64_t code = i * nb + j;
                if (pat.insert(code).second) {
                    if (i > j) lower[j].insert(i);
                    else if (i < j) upper[i].insert(j);
                }
            }
        }
    }
    if ((int64_t)pat.size() > cap) return -1;
    int64_t c = 0;
    for (int64_t code : pat) out_pairs[c++] = code;
    return c;
}

}  // extern "C"
