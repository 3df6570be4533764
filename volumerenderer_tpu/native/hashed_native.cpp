// Native port of the Morton-hashed kd-tree builder
// (volumerenderer_tpu/codecs/hashed.py _Builder — itself a redesign of the
// reference HashedKdtree.cpp:20-507).  The two build passes are inherently
// sequential (hash-slot ownership and evictions depend on DFS visit order;
// the distance sums are running means in that same order), so host-native
// code is the right tool; the accelerator side is the device decode
// (codecs/hashed.py level_cut_device_hashed).  Semantics are bit-identical
// to the Python builder: same double arithmetic, same tie order
// (none > add > sub), same eviction bookkeeping, same deterministic child
// pick replacing the reference's std::shuffle.
#include <cstdint>
#include <cmath>
#include <unordered_map>
#include <vector>
#include <algorithm>

namespace {

constexpr int MAX_ADD = 4;       // HashedKdtree.h:81
constexpr int ADD_START = 64;    // HashedKdtree.h:80

struct HB {
    const uint8_t* mid;       // flat pyramid, level d at offset 2^d - 1
    const uint8_t* uniform;   // same layout, 0/1
    int32_t D;
    int32_t tree_depth;
    int64_t hash_mask;
    int32_t tolerance;
    uint8_t* temp;            // size n
    int64_t* visited;         // size n
    uint8_t* tree_data;       // size n
    uint8_t* tree_structure;  // size n
    uint8_t* temp_coll;
    uint8_t* coll_data;
    uint8_t* coll_structure;
    int64_t* key_by_idx;      // collision idx -> mcode
    int64_t last_coll_idx = 0;
    std::unordered_map<int64_t, int64_t> collisions;
    double sums[64] = {0};
    double counts[64] = {0};
    uint8_t distance_map[64] = {0};
    int add_dist = ADD_START;
    int add_left = MAX_ADD;
};

inline int det_child(int64_t mcode) {
    const uint64_t h = (uint64_t)mcode * 0x9E3779B97F4A7C15ull;
    return 1 + (int)((h >> 61) & 1);
}

// _resolve (hashed.py:132-158)
inline bool resolve(HB& b, int64_t mcode, int64_t& key_out) {
    const int64_t key = mcode & b.hash_mask;
    bool is_coll = b.tree_data[key] == 3;
    if (!is_coll) {
        if (b.visited[key] == 0) {
            b.visited[key] = mcode;
        } else if (b.visited[key] != mcode) {
            const int64_t prev = b.visited[key];
            if (b.collisions.find(prev) == b.collisions.end()) {
                const int64_t pidx = b.last_coll_idx++;
                b.collisions.emplace(prev, pidx);
                b.key_by_idx[pidx] = prev;
                b.temp_coll[pidx] = b.temp[key];
                b.coll_structure[pidx] = b.tree_structure[key];
                b.coll_data[pidx] = b.tree_data[key];
            }
            if (b.collisions.find(mcode) == b.collisions.end()) {
                b.collisions.emplace(mcode, b.last_coll_idx);
                b.key_by_idx[b.last_coll_idx] = mcode;
                b.last_coll_idx++;
            }
            b.tree_data[key] = 3;
            is_coll = true;
        }
    }
    if (is_coll) {
        auto it = b.collisions.find(mcode);
        if (it == b.collisions.end()) {
            it = b.collisions.emplace(mcode, b.last_coll_idx).first;
            b.key_by_idx[b.last_coll_idx] = mcode;
            b.last_coll_idx++;
        }
        key_out = it->second;
        return true;
    }
    key_out = key;
    return false;
}

// _encode (hashed.py:162-195); returns est, writes the code per use_map rules
inline int encode_store(HB& b, int32_t depth, int parent, int truth,
                        bool use_map, bool is_coll, int64_t key) {
    const double pe = (double)parent;
    const double t = (double)truth;
    const double pd = std::fabs(pe - t);
    const double md = use_map ? (double)b.distance_map[depth]
                              : (b.sums[depth] + pd) / (b.counts[depth] + 1.0);
    const double none_err = pd;
    const double add_est = std::min(255.0, pe + md);
    const double add_err = std::fabs(add_est - t);
    const double sub_est = std::max(0.0, pe - md);
    const double sub_err = std::fabs(sub_est - t);
    const double min_err = std::min(sub_err, std::min(none_err, add_err));
    int code;
    double est;
    if (min_err == none_err) {
        code = 0; est = pe;
    } else if (min_err == add_err) {
        code = 1; est = add_est;
        if (!use_map) { b.sums[depth] += add_err; b.counts[depth] += 1; }
    } else {
        code = 2; est = sub_est;
        if (!use_map) { b.sums[depth] += sub_err; b.counts[depth] += 1; }
    }
    if (use_map) {
        if (is_coll) b.coll_data[key] = (uint8_t)code;
        else b.tree_data[key] = (uint8_t)code;
    }
    return (int)est;
}

// pass1 (hashed.py:199-221): explicit DFS, left first
void pass1(HB& b) {
    struct F { int64_t mcode; int32_t depth; int64_t li; int parent_est; };
    std::vector<F> stack;
    stack.push_back({1, 0, 0, 0});
    while (!stack.empty()) {
        const F f = stack.back();
        stack.pop_back();
        const int64_t off = ((int64_t)1 << f.depth) - 1;
        const int midrange = b.mid[off + f.li];
        const bool is_leaf = b.uniform[off + f.li] != 0;
        int64_t key;
        const bool is_coll = resolve(b, f.mcode, key);
        if (is_coll) b.temp_coll[key] = (uint8_t)midrange;
        else b.temp[key] = (uint8_t)midrange;
        const int est = encode_store(b, f.depth, f.parent_est, midrange,
                                     false, is_coll, key);
        if (f.depth < b.D) {
            if (!is_leaf) {
                if (is_coll) b.coll_structure[key] = 3;
                else b.tree_structure[key] = 3;
            }
            stack.push_back({2 * f.mcode + 1, f.depth + 1, 2 * f.li + 1, est});
            stack.push_back({2 * f.mcode + 0, f.depth + 1, 2 * f.li + 0, est});
        }
    }
}

// pass2 (hashed.py:225-279): recursion, left subtree fully before right
void rec2(HB& b, int64_t mcode, int32_t depth, int parent_est,
          int true_override) {
    int64_t key;
    const bool is_coll = resolve(b, mcode, key);
    int children;
    int truth;
    if (is_coll) {
        children = b.coll_structure[key];
        truth = true_override != -1 ? true_override : (int)b.temp_coll[key];
    } else {
        children = b.tree_structure[key];
        truth = true_override != -1 ? true_override : (int)b.temp[key];
    }
    const int est = encode_store(b, depth, parent_est, truth, true, is_coll,
                                 key);
    if (children == 0) {
        const int leaf_err = std::abs(est - truth);
        if (leaf_err > 0 && depth < b.D) {
            children = 3;
            if (is_coll) b.coll_structure[key] = 3;
            else b.tree_structure[key] = 3;
        } else if (leaf_err > b.tolerance
                   && (depth < b.tree_depth || b.add_left > 0)) {
            children = det_child(mcode);
            if (is_coll) b.coll_structure[key] = (uint8_t)children;
            else b.tree_structure[key] = (uint8_t)children;
            true_override = truth;
            if (depth == b.tree_depth && b.add_left > 0) {
                b.tree_depth += 1;
                b.distance_map[b.tree_depth] = (uint8_t)b.add_dist;
                b.add_dist /= 2;
                b.add_left -= 1;
            }
        } else {
            return;
        }
    }
    if (children == 3 || children == 1)
        rec2(b, 2 * mcode, depth + 1, est, true_override);
    if (children == 3 || children == 2)
        rec2(b, 2 * mcode + 1, depth + 1, est, true_override);
}

}  // namespace

extern "C" int64_t hashed_build_native(
    const uint8_t* mid_flat, const uint8_t* uniform_flat, int32_t D,
    int32_t tolerance, uint8_t* tree_data, uint8_t* tree_structure,
    uint8_t* coll_data, uint8_t* coll_structure, int64_t* key_by_idx,
    uint8_t* distance_map_out /* size >= D + 1 + MAX_ADD */,
    int32_t* tree_depth_out) {
    const int64_t n = (int64_t)1 << D;
    std::vector<uint8_t> temp(n, 0);
    std::vector<int64_t> visited(n, 0);
    // collision value arrays are caller-allocated at the same safe bound the
    // Python builder uses (hashed.py:116-120)
    const int64_t ncoll = 2 * (2 * n + MAX_ADD * n) + 8;
    std::vector<uint8_t> temp_coll(ncoll, 0);

    HB b;
    b.mid = mid_flat;
    b.uniform = uniform_flat;
    b.D = D;
    b.tree_depth = D;
    b.hash_mask = n - 1;
    b.tolerance = tolerance;
    b.temp = temp.data();
    b.visited = visited.data();
    b.tree_data = tree_data;
    b.tree_structure = tree_structure;
    b.temp_coll = temp_coll.data();
    b.coll_data = coll_data;
    b.coll_structure = coll_structure;
    b.key_by_idx = key_by_idx;

    pass1(b);
    // distanceMap[d] = (byte)(sums/counts), truncation (HashedKdtree.cpp:60)
    for (int d = 0; d <= D; ++d)
        b.distance_map[d] = b.counts[d] > 0
            ? (uint8_t)(b.sums[d] / std::max(b.counts[d], 1.0)) : 0;
    rec2(b, 1, 0, 0, -1);

    for (int d = 0; d <= b.tree_depth; ++d)
        distance_map_out[d] = b.distance_map[d];
    *tree_depth_out = b.tree_depth;
    return b.last_coll_idx;
}
