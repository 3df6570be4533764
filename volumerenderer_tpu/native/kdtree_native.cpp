// Native kernels for the host-side sequential pieces of the kd-tree codec.
//
// The Δ-seeding sweep (reference encodeNodeEstimate level-order pass,
// VolumeKdTree_recover.cpp:254-267,415-455) carries a running (sum, count)
// scalar state through every node of a level — inherently sequential, so it
// runs here at native speed instead of a Python loop.  Everything else in the
// codec is data-parallel and lives in JAX/NumPy.
//
// Built as a plain shared library, bound via ctypes (no pybind11 dependency).

#include <cstdint>
#include <cmath>
#include <cstddef>

extern "C" {

// Seed one level: truth[n], parent[n] are doubles (exact byte values).
// Writes {sum, count} into out[2].
void seed_level_f64(const double* truth, const double* parent, int64_t n,
                    double* out) {
    double sum = 0.0, count = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        const double t = truth[i];
        const double pe = parent[i];
        const double pd = std::fabs(pe - t);
        const double md = (sum + pd) / (count + 1.0);
        const double none_err = pd;
        const double add_est = md + pe > 255.0 ? 255.0 : pe + md;
        const double add_err = std::fabs(add_est - t);
        const double sub_est = pe - md < 0.0 ? 0.0 : pe - md;
        const double sub_err = std::fabs(sub_est - t);
        double min_err = none_err < add_err ? none_err : add_err;
        min_err = sub_err < min_err ? sub_err : min_err;
        if (min_err == none_err) continue;  // tie order: none beats add/sub
        sum += pd;
        count += 1.0;
    }
    out[0] = sum;
    out[1] = count;
}

// Fused per-level evaluation used by gradient descent: encode every node at a
// fixed integer distance and return the exact sum of squared minimum errors.
// truth/parent are uint8/int32; everything is integer-exact.
// If codes/recon are non-null they are filled.
int64_t encode_level_i32(const uint8_t* truth, const int32_t* parent,
                         int64_t n, int32_t distance,
                         uint8_t* codes, int32_t* recon) {
    int64_t sum_sq = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int32_t t = truth[i];
        const int32_t pe = parent[i];
        const int32_t none_err = pe > t ? pe - t : t - pe;
        int32_t add_est = pe + distance; if (add_est > 255) add_est = 255;
        const int32_t add_err = add_est > t ? add_est - t : t - add_est;
        int32_t sub_est = pe - distance; if (sub_est < 0) sub_est = 0;
        const int32_t sub_err = sub_est > t ? sub_est - t : t - sub_est;
        int32_t min_err = none_err < add_err ? none_err : add_err;
        min_err = sub_err < min_err ? sub_err : min_err;
        uint8_t code;
        int32_t r;
        if (min_err == none_err)      { code = 0; r = pe; }
        else if (min_err == add_err)  { code = 1; r = add_est; }
        else                          { code = 2; r = sub_est; }
        if (codes) codes[i] = code;
        if (recon) recon[i] = r;
        sum_sq += static_cast<int64_t>(min_err) * min_err;
    }
    return sum_sq;
}

}  // extern "C"

// Preorder stack-machine decoder (levelCut, VolumeKdTree_recover.cpp:726-835,
// with frozen-scalar semantics below the cut — see codecs/reference_impl.py).
// The preorder walk is inherently sequential; at native speed it makes
// arbitrary-dimension (non-power-of-two) volumes practical to decode.
extern "C" void decode_preorder_native(
    const uint8_t* preorder, int64_t num_active, const uint8_t* distance_map,
    int64_t X, int64_t Y, int64_t Z, int32_t orig_depth, int32_t max_depth,
    int32_t cut_depth, uint8_t* out) {

    struct Frame {
        int64_t idx;
        int32_t depth;
        int32_t scalar;
        int64_t mn[3];
        int64_t mx[3];
    };
    // stack depth bounded by max_depth + 2
    Frame* stack = new Frame[max_depth + 4];
    int top = 0;
    stack[0] = Frame{0, 0, (int32_t)distance_map[0], {0, 0, 0}, {X, Y, Z}};

    auto child_scalar = [&](int32_t scalar, int code, int32_t parent_depth) {
        const int32_t d = parent_depth + 1;
        if (d > cut_depth) return scalar;
        if (code == 1) {
            int32_t v = scalar + (int32_t)distance_map[d];
            return v > 255 ? 255 : v;
        }
        if (code == 2) {
            int32_t v = scalar - (int32_t)distance_map[d];
            return v < 0 ? 0 : v;
        }
        return scalar;
    };

    auto split_dim = [&](const Frame& f) {
        int64_t ext[3] = {f.mx[0] - f.mn[0], f.mx[1] - f.mn[1], f.mx[2] - f.mn[2]};
        if (ext[0] * ext[1] * ext[2] <= 1) return -1;
        int sd = f.depth % 3;
        int i = 0;
        while (ext[sd] == 1) { ++i; sd = (f.depth + i) % 3; }
        return sd;
    };

    while (top >= 0) {
        Frame f = stack[top];
        const int code = (preorder[f.idx >> 2] >> ((f.idx & 3) * 2)) & 3;
        if (code == 3 || f.depth == max_depth) {
            for (int64_t x = f.mn[0]; x < f.mx[0]; ++x)
                for (int64_t y = f.mn[1]; y < f.mx[1]; ++y)
                    for (int64_t z = f.mn[2]; z < f.mx[2]; ++z)
                        out[x + X * y + X * Y * z] = (uint8_t)f.scalar;
            --top;
            const int64_t nxt = f.idx + 1;
            if (nxt < num_active && top >= 0) {
                Frame p = stack[top];
                --top;
                const int ncode = (preorder[nxt >> 2] >> ((nxt & 3) * 2)) & 3;
                Frame c = p;
                c.idx = nxt;
                c.depth = p.depth + 1;
                c.scalar = child_scalar(p.scalar, ncode, p.depth);
                const int sd = split_dim(p);
                if (sd >= 0) c.mn[sd] = (p.mn[sd] + p.mx[sd]) / 2;
                stack[++top] = c;
            }
        } else {
            if (f.depth >= orig_depth) --top;
            const int64_t nxt = f.idx + 1;
            const int ncode = (preorder[nxt >> 2] >> ((nxt & 3) * 2)) & 3;
            Frame c = f;
            c.idx = nxt;
            c.depth = f.depth + 1;
            c.scalar = child_scalar(f.scalar, ncode, f.depth);
            const int sd = split_dim(f);
            if (sd >= 0) c.mx[sd] = (f.mn[sd] + f.mx[sd]) / 2;
            stack[++top] = c;
        }
    }
    delete[] stack;
}

// ---------------------------------------------------------------------------
// Full sequential kd-tree build for ARBITRARY (incl. non-power-of-two) dims —
// native port of the reference pipeline (VolumeKdTree_recover.cpp:17-724)
// with the two documented semantic fixes of codecs/kdtree.py (fresh error per
// evaluation; final re-encode at the chosen delta).  This is the path for the
// reference's own full-volume config (2048x2048x768), where the vectorized
// power-of-two codec does not apply and Python is too slow.
// ---------------------------------------------------------------------------

#include <vector>
#include <stack>
#include <tuple>
#include <thread>
#include <future>

// Build-phase parallelism: 2-way fork-join on the kd children (the host-side
// analogue of the reference's PPL parallel_invoke, VolumeKdTree_recover.cpp
// :175-178,607-610) plus chunked level sweeps with exact int64 partial sums
// (order-independent: e^2 sums stay below 2^53, so the double mean is
// bit-identical to the sequential accumulation).
static int g_threads =
    (int)std::thread::hardware_concurrency() > 0
        ? (int)std::thread::hardware_concurrency() : 1;

extern "C" void set_native_threads(int n) { g_threads = n < 1 ? 1 : n; }

namespace {

int fork_levels() {
    int l = 0;
    while ((1 << l) < g_threads) ++l;
    return l;
}

struct BuildCtx {
    const uint8_t* data;
    int64_t X, Y, Z;
    int orig_depth;
    std::vector<uint8_t> temp;       // breadth-first node values
    std::vector<uint8_t> codes;      // 2-bit codes stored as bytes
    std::vector<int32_t> recon;      // leaf reconstructions
    int64_t first_leaf;

    int64_t cell(int64_t x, int64_t y, int64_t z) const {
        return x + X * y + X * Y * z;
    }
};

struct MinMax8 { uint8_t mn, mx; };

MinMax8 build_rec(BuildCtx& c, int64_t idx, int depth, int64_t mn[3],
                  int64_t mx[3], int forks) {
    MinMax8 r;
    if (depth < c.orig_depth) {
        int sd = depth % 3;
        int64_t ext[3] = {mx[0] - mn[0], mx[1] - mn[1], mx[2] - mn[2]};
        int64_t cells = ext[0] * ext[1] * ext[2];
        int i = 0;
        while (cells > 1 && ext[sd] == 1) { ++i; sd = (depth + i) % 3; }
        const int64_t mid = (mn[sd] + mx[sd]) / 2;
        const int64_t hi = mx[sd];
        int64_t a_mn[3] = {mn[0], mn[1], mn[2]};
        int64_t a_mx[3] = {mx[0], mx[1], mx[2]};
        a_mx[sd] = mid;
        int64_t b_mn[3] = {mn[0], mn[1], mn[2]};
        int64_t b_mx[3] = {mx[0], mx[1], mx[2]};
        b_mn[sd] = mid; b_mx[sd] = hi;
        MinMax8 l, h;
        if (forks > 0 && depth + 1 < c.orig_depth) {
            auto fut = std::async(std::launch::async, [&] {
                return build_rec(c, 2 * idx + 1, depth + 1, a_mn, a_mx,
                                 forks - 1);
            });
            h = build_rec(c, 2 * idx + 2, depth + 1, b_mn, b_mx, forks - 1);
            l = fut.get();
        } else {
            l = build_rec(c, 2 * idx + 1, depth + 1, a_mn, a_mx, 0);
            h = build_rec(c, 2 * idx + 2, depth + 1, b_mn, b_mx, 0);
        }
        r.mn = l.mn < h.mn ? l.mn : h.mn;
        r.mx = l.mx > h.mx ? l.mx : h.mx;
    } else {
        r.mn = r.mx = c.data[c.cell(mn[0], mn[1], mn[2])];
    }
    c.temp[idx] = (uint8_t)(((int)r.mx + (int)r.mn) / 2);
    return r;
}

// encodeNode on integer values; returns estimate, writes code if fill
inline int enc(int truth, int parent, int dist, uint8_t* code_out, int64_t* err_out) {
    const int none_err = parent > truth ? parent - truth : truth - parent;
    int add_est = parent + dist; if (add_est > 255) add_est = 255;
    const int add_err = add_est > truth ? add_est - truth : truth - add_est;
    int sub_est = parent - dist; if (sub_est < 0) sub_est = 0;
    const int sub_err = sub_est > truth ? sub_est - truth : truth - sub_est;
    int min_err = none_err < add_err ? none_err : add_err;
    min_err = sub_err < min_err ? sub_err : min_err;
    if (err_out) *err_out = min_err;
    if (min_err == none_err) { if (code_out) *code_out = 0; return parent; }
    if (min_err == add_err)  { if (code_out) *code_out = 1; return add_est; }
    if (code_out) *code_out = 2;
    return sub_est;
}

bool prune_rec(BuildCtx& c, int64_t root, int tol, int forks) {
    // depth = floor(log2(root+1))
    int depth = 0;
    for (int64_t v = root + 1; v > 1; v >>= 1) ++depth;
    bool l = true, r = true, meets = true;
    if (depth < c.orig_depth) {
        if (forks > 0 && depth + 1 < c.orig_depth) {
            auto fut = std::async(std::launch::async, [&] {
                return prune_rec(c, 2 * root + 1, tol, forks - 1);
            });
            r = prune_rec(c, 2 * root + 2, tol, forks - 1);
            l = fut.get();
        } else {
            l = prune_rec(c, 2 * root + 1, tol, 0);
            r = prune_rec(c, 2 * root + 2, tol, 0);
        }
    }
    if (depth == c.orig_depth) {
        const int64_t ri = root - c.first_leaf;
        int d = c.recon[ri] - (int)c.temp[c.first_leaf + ri];
        meets = (d < 0 ? -d : d) < tol;
    }
    if (l && r && c.codes[root] == 0 && meets) {
        c.codes[root] = 3;
        return true;
    }
    return false;
}

inline void set2(uint8_t* packed, int64_t i, int v) {
    const int64_t b = i >> 2;
    const int sh = (int)(i & 3) * 2;
    packed[b] = (uint8_t)((packed[b] & ~(3 << sh)) | (v << sh));
}

}  // namespace

extern "C" int64_t build_full_native(
    const uint8_t* data, int64_t X, int64_t Y, int64_t Z,
    int32_t tolerance, int32_t max_epochs,
    int32_t orig_depth, int32_t max_depth,
    uint8_t* distance_map /* max_depth+1, extra levels prefilled by caller */,
    uint8_t* preorder_packed /* (num_max_nodes+3)/4, zeroed by caller */,
    int32_t* leaf_recon_out /* 2^orig_depth, optional (may be null) */) {

    BuildCtx c;
    c.data = data; c.X = X; c.Y = Y; c.Z = Z; c.orig_depth = orig_depth;
    const int64_t num_nodes = ((int64_t)1 << (orig_depth + 1)) - 1;
    c.first_leaf = ((int64_t)1 << orig_depth) - 1;
    c.temp.resize(num_nodes);
    c.codes.assign(num_nodes, 0);

    // PASS 1
    int64_t mn[3] = {0, 0, 0};
    int64_t mx[3] = {X, Y, Z};
    build_rec(c, 0, 0, mn, mx, fork_levels());

    // PASS 2 — per-level seed + GD (fixed semantics; see kdtree.py docstring)
    std::vector<int32_t> recon_parents;
    int64_t start = 0, parent_start = 0;
    for (int depth = 0; depth <= orig_depth; ++depth) {
        const int64_t n = (int64_t)1 << depth;
        const int64_t end = start + n;
        c.recon.assign(n, 0);

        // seeding (sequential running mean, :415-455)
        double sum = 0.0, count = 0.0;
        for (int64_t i = start; i < end; ++i) {
            const int parent = i == 0 ? 0 : recon_parents[((i - 1) / 2) - parent_start];
            const double t = (double)c.temp[i];
            const double pd = parent > t ? parent - t : t - parent;
            const double md = (sum + pd) / (count + 1.0);
            const double ae = std::fabs((md + parent > 255.0 ? 255.0 : parent + md) - t);
            const double se = std::fabs((parent - md < 0.0 ? 0.0 : parent - md) - t);
            double me = pd < ae ? pd : ae;
            me = se < me ? se : me;
            if (me == pd) continue;
            sum += pd; count += 1.0;
        }
        double cur = count > 0 ? std::floor(sum / count + 0.5) : 0.0;

        auto eval_range = [&](int dist, bool fill, int64_t lo, int64_t hi) {
            int64_t sum_sq = 0;
            for (int64_t i = lo; i < hi; ++i) {
                const int parent = i == 0 ? 0 : recon_parents[((i - 1) / 2) - parent_start];
                int64_t e;
                uint8_t code;
                const int r = enc(c.temp[i], parent, dist, fill ? &code : nullptr, &e);
                if (fill) { c.codes[i] = code; c.recon[i - start] = r; }
                sum_sq += e * e;
            }
            return sum_sq;
        };
        auto eval = [&](int dist, bool fill) {
            const int T = (g_threads > 1 && n >= (1 << 16)) ? g_threads : 1;
            int64_t total = 0;
            if (T == 1) {
                total = eval_range(dist, fill, start, end);
            } else {
                std::vector<std::future<int64_t>> futs;
                for (int t = 1; t < T; ++t)
                    futs.push_back(std::async(std::launch::async, eval_range,
                                              dist, fill, start + n * t / T,
                                              start + n * (t + 1) / T));
                total = eval_range(dist, fill, start, start + n / T);
                for (auto& f : futs) total += f.get();
            }
            return (double)total / (double)n;
        };

        int epoch = 0;
        double prev_dist = 0.0, prev_step = 255.0, prev_err = 65025.0;
        double cur_err = 0.0, cur_df = 0.0, cur_step = 0.0, prev_df = 0.0;
        while (epoch < max_epochs && std::fabs(prev_step) >= 0.5) {
            if (epoch != 0) {
                prev_dist = cur; prev_err = cur_err; prev_df = cur_df; prev_step = cur_step;
                double nd = prev_dist + prev_step;
                nd = nd < 0.0 ? 0.0 : (nd > 255.0 ? 255.0 : nd);
                cur = std::floor(nd + 0.5);
                if (cur == prev_dist) break;
            }
            cur_err = eval((int)cur, true);
            if (cur_err < 1.0) break;
            if (epoch != 0 && cur_err > prev_err) {
                cur_err = prev_err; cur = prev_dist; cur_df = prev_df;
                cur_step = prev_step / 2.0;
                ++epoch;
                continue;
            }
            const double lo = cur - 1.0 < 0.0 ? 0.0 : cur - 1.0;
            const double hi = cur + 1.0 > 255.0 ? 255.0 : cur + 1.0;
            const double e_lo = eval((int)lo, false);
            const double e_hi = eval((int)hi, false);
            cur_df = (e_hi - e_lo) / 2.0;
            cur_step = -1.25 * cur_df;
            if (cur_step > 4.0) cur_step = 4.0;
            if (cur_step < -4.0) cur_step = -4.0;
            ++epoch;
        }
        distance_map[depth] = (uint8_t)cur;
        eval((int)cur, true);  // final re-encode

        recon_parents.swap(c.recon);
        parent_start = start;
        start = end;
    }
    c.recon.swap(recon_parents);  // leaf reconstructions

    // PASS 3
    prune_rec(c, 0, tolerance, fork_levels());

    // PASS 4 — preorder emit with branch growth (stack machine, :631-724)
    int64_t out_idx = 0;
    struct F { int64_t idx; int depth; bool ev; int64_t zero_start; };
    std::vector<F> stack;
    stack.push_back({0, 0, false, -1});
    while (!stack.empty()) {
        F f = stack.back();
        stack.pop_back();
        int code = c.codes[f.idx];
        int64_t ri = -1;
        if (f.depth >= orig_depth) {
            ri = f.idx - c.first_leaf;
            if (f.ev) {
                int64_t e;
                uint8_t nc;
                const int r = enc(c.temp[c.first_leaf + ri], c.recon[ri],
                                  distance_map[f.depth], &nc, &e);
                c.recon[ri] = r;
                c.codes[f.idx] = nc;
                code = nc;
                if (f.zero_start != -1) { if (code != 0) f.zero_start = -1; }
                else if (code == 0) f.zero_start = out_idx;
            } else if (f.depth > orig_depth) {
                code = 3;
            }
        }
        set2(preorder_packed, out_idx++, code);
        if (f.depth >= max_depth || code == 3) {
            if (f.zero_start != -1)
                for (int64_t i = f.zero_start; i < out_idx; ++i)
                    set2(preorder_packed, i, 3);
            continue;
        }
        if (f.depth >= orig_depth) {
            int d = c.recon[ri] - (int)c.temp[c.first_leaf + ri];
            if ((d < 0 ? -d : d) > tolerance)
                stack.push_back({f.idx, f.depth + 1, true, f.zero_start});
            else
                stack.push_back({f.idx, f.depth + 1, false, f.zero_start});
            continue;
        }
        stack.push_back({2 * f.idx + 2, f.depth + 1, false, f.zero_start});
        stack.push_back({2 * f.idx + 1, f.depth + 1, false, f.zero_start});
    }

    if (leaf_recon_out)
        for (int64_t i = 0; i < ((int64_t)1 << orig_depth); ++i)
            leaf_recon_out[i] = c.recon[i];
    return out_idx;
}

// Inverse of the preorder flatten: walk the packed 2-bit stream with the
// SAME stack automaton as decode_preorder_native and record each node's
// code at its (depth, breadth-first index) — rebuilding the level-structured
// layout (codecs/kdtree.py KdTree) from a checkpoint file so resumed
// timesteps keep the compressed-renderer path (VERDICT round 1 weak #6).
// levels_flat: 2^(orig_depth+1)-1 bytes, level d at offset 2^d - 1
// (caller prefills 3); chains: 2^orig_depth x chain_len (caller prefills
// 255 = NO_NODE).
extern "C" void preorder_to_levels_native(
    const uint8_t* preorder, int64_t num_active, int32_t orig_depth,
    int32_t max_depth, uint8_t* levels_flat, uint8_t* chains,
    int32_t chain_len) {
    struct Frame { int64_t idx; int32_t depth; int64_t bf; };
    Frame* stack = new Frame[max_depth + 4];
    int top = 0;
    stack[0] = Frame{0, 0, 0};
    while (top >= 0) {
        Frame f = stack[top];
        const int code = (preorder[f.idx >> 2] >> ((f.idx & 3) * 2)) & 3;
        if (f.depth <= orig_depth)
            levels_flat[(((int64_t)1) << f.depth) - 1 + f.bf] = (uint8_t)code;
        else if (f.depth - orig_depth - 1 < chain_len)
            chains[f.bf * chain_len + (f.depth - orig_depth - 1)] = (uint8_t)code;
        if (code == 3 || f.depth == max_depth) {
            --top;
            const int64_t nxt = f.idx + 1;
            if (nxt < num_active && top >= 0) {
                Frame p = stack[top];
                --top;
                stack[++top] = Frame{nxt, p.depth + 1, 2 * p.bf + 1};
            }
        } else {
            if (f.depth >= orig_depth) --top;
            const int64_t nxt = f.idx + 1;
            const int64_t cbf = f.depth < orig_depth ? 2 * f.bf : f.bf;
            stack[++top] = Frame{nxt, f.depth + 1, cbf};
        }
    }
    delete[] stack;
}
