// Native linearizability checker for the port's host runtime (built
// with g++ and loaded through ctypes by paxi_tpu_torch/host/native.py).
//
// Mirrors paxi_tpu_torch/host/history.py check_key()/_find_cycle_read()
// exactly (reference: paxi history.go / linearizability.go — precedence
// graph over one key's ops: real-time order + read-from data order +
// closure rules, anomalies counted by removing one offending read per
// detected cycle).  Row-major bitset adjacency, Warshall closure in
// n^3/64 word ops; called from Python via ctypes (host/history.py picks
// this over the pure-Python path when the library is built).
//
// Per-op encoding (one key's operations, arrays of length n):
//   is_read[i] : 1 if read
//   val[i]     : written-value id for writes; read-value id for reads;
//                EMPTY_VAL (-2) for a read returning the initial value
//   start[i], end[i] : real-time interval (end may be +inf for open ops)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t EMPTY_VAL = -2;

struct Bitset {
    std::vector<uint64_t> w;
    explicit Bitset(int n) : w((n + 63) / 64, 0) {}
    void set(int i) { w[i >> 6] |= (1ull << (i & 63)); }
    bool get(int i) const { return (w[i >> 6] >> (i & 63)) & 1; }
    void orWith(const Bitset& o) {
        for (size_t k = 0; k < w.size(); ++k) w[k] |= o.w[k];
    }
    bool intersects(const Bitset& o) const {
        for (size_t k = 0; k < w.size(); ++k)
            if (w[k] & o.w[k]) return true;
        return false;
    }
};

// Warshall transitive closure over bitset rows.
void closure(std::vector<Bitset>& reach, int n) {
    for (int k = 0; k < n; ++k) {
        const Bitset& rk = reach[k];
        for (int i = 0; i < n; ++i) {
            if (reach[i].get(k)) reach[i].orWith(rk);
        }
    }
}

// Returns the index of a read on a cycle (preferring reads), the index
// of any cycle node otherwise, or -1 if linearizable.
int find_cycle_read(const int32_t* is_read, const int64_t* val,
                    const double* start, const double* end,
                    const std::vector<int>& alive) {
    const int n = static_cast<int>(alive.size());
    if (n == 0) return -1;

    std::vector<Bitset> adj(n, Bitset(n));
    std::vector<int> writes;
    for (int i = 0; i < n; ++i)
        if (!is_read[alive[i]]) writes.push_back(i);

    // real-time precedence
    for (int i = 0; i < n; ++i) {
        const double ei = end[alive[i]];
        for (int j = 0; j < n; ++j)
            if (i != j && ei < start[alive[j]]) adj[i].set(j);
    }

    // read-from edges; a non-empty read of a never-written value is
    // itself an anomaly; an empty (initial-value) read precedes every
    // write (lost-update detection)
    std::vector<int> read_from(n, -1);
    for (int i = 0; i < n; ++i) {
        if (!is_read[alive[i]]) continue;
        const int64_t v = val[alive[i]];
        if (v == EMPTY_VAL) {
            for (int w : writes) adj[i].set(w);
            continue;
        }
        int w = -1;
        for (int j : writes)
            if (val[alive[j]] == v) { w = j; }
        if (w < 0) return alive[i];
        adj[w].set(i);
        read_from[i] = w;
    }

    // closure fixpoint with the two data-order rules per read r of w:
    //  (a) any write reaching r precedes w; (b) r precedes any write
    //  that w reaches
    while (true) {
        std::vector<Bitset> reach = adj;
        closure(reach, n);
        bool changed = false;
        for (int r = 0; r < n; ++r) {
            const int w = read_from[r];
            if (w < 0) continue;
            for (int w2 : writes) {
                if (w2 == w) continue;
                if (reach[w2].get(r) && !adj[w2].get(w)) {
                    adj[w2].set(w);
                    changed = true;
                }
                if (reach[w].get(w2) && r != w2 && !adj[r].get(w2)) {
                    adj[r].set(w2);
                    changed = true;
                }
            }
        }
        if (!changed) break;
    }

    std::vector<Bitset> reach = adj;
    closure(reach, n);
    int any = -1;
    for (int i = 0; i < n; ++i) {
        if (reach[i].get(i)) {
            if (is_read[alive[i]]) return alive[i];
            if (any < 0) any = alive[i];
        }
    }
    return any;
}

}  // namespace

extern "C" {

// Anomalous-op count for one key's history (python check_key parity).
int32_t lincheck_key(const int32_t* is_read, const int64_t* val,
                     const double* start, const double* end, int32_t n) {
    std::vector<int> alive(n);
    for (int i = 0; i < n; ++i) alive[i] = i;
    std::vector<char> removed(n, 0);
    int32_t anomalies = 0;
    while (true) {
        int bad = find_cycle_read(is_read, val, start, end, alive);
        if (bad < 0) return anomalies;
        ++anomalies;
        removed[bad] = 1;
        alive.clear();
        for (int i = 0; i < n; ++i)
            if (!removed[i]) alive.push_back(i);
    }
}

int32_t lincheck_version() { return 1; }

}  // extern "C"
