// dgcore — native host runtime for dipgenie_tpu.
//
// C++ equivalents of the reference's native compute components (reference
// at /root/reference, cited per function), exposed through a C ABI for
// ctypes. These are *new* implementations designed around dense arrays
// handed over from numpy — not ports of the reference's data structures:
//
//   * dg_sketch          — canonical (w,k)-minimizer scan + MurmurHash3
//                          fold (semantics of src/solver.cpp:277-412)
//   * dg_sketch_batch    — OpenMP batch scan over many reads
//   * dg_haploid_dp      — (vertex, r) lattice DP (src/approximator.cpp:44-67)
//   * dg_diploid_dp      — level-synchronous diploid pair DP
//                          (src/approximator.cpp:362-716) in *gather* form:
//                          each destination state reduces over its
//                          predecessor candidates, making the relaxation
//                          lock-free and deterministic (the reference
//                          scatters with 65536 striped locks).
//
// Colour-set scoring uses per-level-window re-indexed bitsets:
// |(A∪B)∩(C∪D)| = popcount((a|b)&(c|d)) and |(E∪F)△(G∪H)| =
// popcount((e|f)^(g|h)) over uint64 words — exactly the counts the
// reference computes with 4-way sorted merges (approximator.cpp:269-311).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <ctime>
#include <cstdlib>
#include <vector>
#include <deque>
#include <unordered_map>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

#include <string>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// MurmurHash3 x64_128 (public-domain algorithm, Austin Appleby) + XOR fold,
// matching hash128_to_64_ (src/solver.cpp:16-24).
// ---------------------------------------------------------------------------
static inline uint64_t rotl64(uint64_t x, int8_t r) {
    return (x << r) | (x >> (64 - r));
}

static inline uint64_t fmix64(uint64_t k) {
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdULL;
    k ^= k >> 33;
    k *= 0xc4ceb9fe1a85ec53ULL;
    k ^= k >> 33;
    return k;
}

uint64_t dg_murmur_fold64(const uint8_t* data, int64_t len) {
    const uint64_t c1 = 0x87c37b91114253d5ULL;
    const uint64_t c2 = 0x4cf5ad432745937fULL;
    uint64_t h1 = 0, h2 = 0;
    const int64_t nblocks = len / 16;
    for (int64_t i = 0; i < nblocks; i++) {
        uint64_t k1, k2;
        memcpy(&k1, data + 16 * i, 8);
        memcpy(&k2, data + 16 * i + 8, 8);
        k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
        h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729;
        k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
        h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5;
    }
    const uint8_t* tail = data + nblocks * 16;
    uint64_t k1 = 0, k2 = 0;
    switch (len & 15) {
        case 15: k2 ^= ((uint64_t)tail[14]) << 48; [[fallthrough]];
        case 14: k2 ^= ((uint64_t)tail[13]) << 40; [[fallthrough]];
        case 13: k2 ^= ((uint64_t)tail[12]) << 32; [[fallthrough]];
        case 12: k2 ^= ((uint64_t)tail[11]) << 24; [[fallthrough]];
        case 11: k2 ^= ((uint64_t)tail[10]) << 16; [[fallthrough]];
        case 10: k2 ^= ((uint64_t)tail[9]) << 8; [[fallthrough]];
        case 9:
            k2 ^= ((uint64_t)tail[8]);
            k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
            [[fallthrough]];
        case 8: k1 ^= ((uint64_t)tail[7]) << 56; [[fallthrough]];
        case 7: k1 ^= ((uint64_t)tail[6]) << 48; [[fallthrough]];
        case 6: k1 ^= ((uint64_t)tail[5]) << 40; [[fallthrough]];
        case 5: k1 ^= ((uint64_t)tail[4]) << 32; [[fallthrough]];
        case 4: k1 ^= ((uint64_t)tail[3]) << 24; [[fallthrough]];
        case 3: k1 ^= ((uint64_t)tail[2]) << 16; [[fallthrough]];
        case 2: k1 ^= ((uint64_t)tail[1]) << 8; [[fallthrough]];
        case 1:
            k1 ^= ((uint64_t)tail[0]);
            k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    }
    h1 ^= (uint64_t)len; h2 ^= (uint64_t)len;
    h1 += h2; h2 += h1;
    h1 = fmix64(h1); h2 = fmix64(h2);
    h1 += h2; h2 += h1;
    return h1 ^ h2;
}

// ---------------------------------------------------------------------------
// Minimizer sketching (semantics of src/solver.cpp:277-412):
// uppercase, canonical = string-min(fwd, revcomp), window min with
// rightmost tie (deque pop rule ">="), consecutive-hash dedup.
// ---------------------------------------------------------------------------

static uint8_t UPPER_TAB[256];
static uint8_t COMP_TAB[256];
static int8_t CODE_TAB[256];
static bool tabs_init = false;

static void init_tabs() {
    if (tabs_init) return;
    for (int i = 0; i < 256; i++) {
        UPPER_TAB[i] = (i >= 'a' && i <= 'z') ? i - 32 : i;
        COMP_TAB[i] = i;
        CODE_TAB[i] = -1;
    }
    COMP_TAB['A'] = 'T'; COMP_TAB['T'] = 'A';
    COMP_TAB['C'] = 'G'; COMP_TAB['G'] = 'C';
    CODE_TAB['A'] = 0; CODE_TAB['C'] = 1; CODE_TAB['G'] = 2; CODE_TAB['T'] = 3;
    tabs_init = true;
}

// Scan one sequence. Returns number of emitted minimizers; fills
// out_hashes/out_pos (caller capacity >= n). Thread-safe after init.
int64_t dg_sketch(const uint8_t* seq, int64_t n, int32_t k, int32_t w,
                  uint64_t* out_hashes, int64_t* out_pos) {
    init_tabs();
    if (n < (int64_t)w + k - 1) return 0;
    std::vector<uint8_t> up(n), crev(n);
    bool pure = true;
    for (int64_t i = 0; i < n; i++) {
        up[i] = UPPER_TAB[seq[i]];
        if (CODE_TAB[up[i]] < 0) pure = false;
    }
    for (int64_t i = 0; i < n; i++) crev[i] = COMP_TAB[up[n - 1 - i]];

    const int64_t nk = n - k + 1;
    int64_t count = 0;
    uint64_t prev_hash = UINT64_MAX;

    auto emit = [&](int64_t pos, bool is_rc) {
        const uint8_t* p = is_rc ? crev.data() + (n - k - pos) : up.data() + pos;
        uint64_t h = dg_murmur_fold64(p, k);
        if (h != prev_hash) {
            prev_hash = h;
            out_hashes[count] = h;
            out_pos[count] = pos;
            count++;
        }
    };

    if (pure && k <= 31) {
        // rolling 2-bit packed canonical k-mers; numeric order == string order
        const uint64_t mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
        std::vector<uint64_t> canon(nk);
        std::vector<uint8_t> isrc(nk);
        uint64_t f = 0, r = 0;
        const int shift = 2 * (k - 1);
        for (int64_t i = 0; i < n; i++) {
            int c = CODE_TAB[up[i]];
            f = ((f << 2) | (uint64_t)c) & mask;
            r = (r >> 2) | ((uint64_t)(3 - c) << shift);
            if (i >= k - 1) {
                int64_t pos = i - k + 1;
                if (r < f) { canon[pos] = r; isrc[pos] = 1; }
                else       { canon[pos] = f; isrc[pos] = 0; }
            }
        }
        // monotonic deque of (value, pos), pop-back on >= (solver.cpp:316)
        std::deque<int64_t> dq;  // positions; values via canon[]
        for (int64_t i = 0; i < nk; i++) {
            while (!dq.empty() && canon[dq.back()] >= canon[i]) dq.pop_back();
            dq.push_back(i);
            if (dq.front() <= i - w) dq.pop_front();
            if (i >= w - 1) emit(dq.front(), isrc[dq.front()]);
        }
    } else {
        // general byte-comparison path (handles N/IUPAC like the reference)
        auto fwd_ptr = [&](int64_t pos) { return up.data() + pos; };
        auto rc_ptr = [&](int64_t pos) { return crev.data() + (n - k - pos); };
        auto canon_ptr = [&](int64_t pos, bool* is_rc) {
            const uint8_t* f = fwd_ptr(pos);
            const uint8_t* r = rc_ptr(pos);
            int c = memcmp(r, f, k);
            *is_rc = c < 0;
            return c < 0 ? r : f;
        };
        std::deque<std::pair<const uint8_t*, int64_t>> dq;
        std::vector<uint8_t> isrc(nk);
        for (int64_t i = 0; i < nk; i++) {
            bool rcflag;
            const uint8_t* cp = canon_ptr(i, &rcflag);
            isrc[i] = rcflag;
            while (!dq.empty() && memcmp(dq.back().first, cp, k) >= 0)
                dq.pop_back();
            dq.emplace_back(cp, i);
            if (dq.front().second <= i - w) dq.pop_front();
            if (i >= w - 1) emit(dq.front().second, isrc[dq.front().second]);
        }
    }
    return count;
}

// Batch scan: reads concatenated in `seqs` with offsets [nreads+1].
// Emits per-read minimizer hash lists into out_hashes with out_offsets.
// Positions are not needed for reads (only the hash set is used).
void dg_sketch_batch(const uint8_t* seqs, const int64_t* offsets,
                     int64_t nreads, int32_t k, int32_t w,
                     uint64_t* out_hashes, int64_t* out_offsets,
                     int32_t n_threads) {
    init_tabs();
#ifdef _OPENMP
    omp_set_num_threads(n_threads > 0 ? n_threads : 1);
#endif
    std::vector<int64_t> counts(nreads, 0);
    std::vector<std::vector<uint64_t>> results(nreads);
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t r = 0; r < nreads; r++) {
        int64_t len = offsets[r + 1] - offsets[r];
        if (len < (int64_t)w + k - 1) continue;
        std::vector<uint64_t> hs(len);
        std::vector<int64_t> ps(len);
        int64_t c = dg_sketch(seqs + offsets[r], len, k, w, hs.data(), ps.data());
        results[r].assign(hs.begin(), hs.begin() + c);
        counts[r] = c;
    }
    int64_t total = 0;
    for (int64_t r = 0; r < nreads; r++) {
        out_offsets[r] = total;
        memcpy(out_hashes + total, results[r].data(), counts[r] * 8);
        total += counts[r];
    }
    out_offsets[nreads] = total;
}

// ---------------------------------------------------------------------------
// Haploid (vertex, r) DP (src/approximator.cpp:44-67 semantics):
// dp starts at 0, strict-improvement backpointers, visit order
// u ascending (topological ids), r ascending, out-edges in order.
// ---------------------------------------------------------------------------
void dg_haploid_dp(int64_t n, int32_t R,
                   const int64_t* adj_ptr, const int32_t* adj_v,
                   const int8_t* adj_w, const int64_t* color_size,
                   int32_t* dp, int32_t* back_vtx, int32_t* back_r) {
    const int32_t W = R + 1;
    memset(dp, 0, sizeof(int32_t) * n * W);
    for (int64_t i = 0; i < n * W; i++) back_vtx[i] = -1;
    for (int64_t i = 0; i < n * W; i++) back_r[i] = -1;
    for (int64_t u = 0; u < n; u++) {
        const int32_t* du = dp + u * W;
        for (int32_t r = 0; r <= R; r++) {
            int32_t base = du[r];
            for (int64_t e = adj_ptr[u]; e < adj_ptr[u + 1]; e++) {
                int32_t v = adj_v[e];
                int32_t wv = adj_w[e];
                int32_t r2 = r + wv;
                if (r2 > R) continue;
                int32_t cand = base + (int32_t)color_size[v];
                int64_t idx = (int64_t)v * W + r2;
                if (cand > dp[idx]) {
                    dp[idx] = cand;
                    back_vtx[idx] = (int32_t)u;
                    back_r[idx] = r;
                }
            }
        }
    }
}

// Backtrack a single r lattice path from vertex n-1. Returns path length
// (reversed order: sink..start); caller reverses.
int64_t dg_backtrack(int64_t n, int32_t R, const int32_t* back_vtx,
                     const int32_t* back_r, int32_t r, int32_t* out_path) {
    const int32_t W = R + 1;
    int64_t len = 0;
    int64_t cur = n - 1;
    int32_t cr = r;
    while (cur != -1) {
        out_path[len++] = (int32_t)cur;
        int64_t idx = cur * W + cr;
        int64_t nv = back_vtx[idx];
        cr = back_r[idx];
        cur = nv;
    }
    return len;
}

// ---------------------------------------------------------------------------
// Diploid level-synchronous pair DP (src/approximator.cpp:362-716
// semantics) in gather form with bitset scoring.
//
// Vertices must be numbered so that level l occupies [level_ptr[l],
// level_ptr[l+1]) — which strict_bfs_levelize_and_reorder guarantees.
// Tie-break matches the reference exactly: max value, then smallest
// pred_i, then smallest pred_j (approximator.cpp:655-659).
//
// out_trans must hold 5*L int32; entry l (1..L-1) receives the winning
// (pred_i, pred_j, pred_r, wu, wv) on the backtracked optimal path.
// Returns the DP sink value; *out_shet receives the s_het bookkeeping.
// ---------------------------------------------------------------------------

static double dg_wall_now() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

// Live DP progress bar, same line shape as the reference
// (approximator.cpp:305-350): 40-char bar, percent, current/total,
// it/s, ETA with h/m segments only when nonzero.
static void dg_progress_bar(size_t current, size_t total, double t0) {
    const size_t width = 40;
    const double frac = total ? (double)current / (double)total : 1.0;
    const size_t n = (size_t)(frac * width);
    const double elapsed = dg_wall_now() - t0;
    const double rate = elapsed > 0 ? (double)current / elapsed : 0.0;
    const double eta =
        (rate > 0 && total > current) ? (double)(total - current) / rate : 0.0;
    char bar[41];
    for (size_t i = 0; i < width; i++)
        bar[i] = i < n ? '=' : (i == n ? '>' : ' ');
    bar[width] = 0;
    long es = (long)eta;
    long eh = es / 3600; es %= 3600;
    long em = es / 60; es %= 60;
    char hms[48];
    if (eh) snprintf(hms, sizeof hms, "%ldh%ldm%lds", eh, em, es);
    else if (em) snprintf(hms, sizeof hms, "%ldm%lds", em, es);
    else snprintf(hms, sizeof hms, "%lds", es);
    fprintf(stderr, "\r[%s] %3d%%  %zu/%zu  | %.1f it/s  | ETA %s         ",
            bar, (int)(frac * 100), current, total, rate, hms);
    if (current == total) fprintf(stderr, "\n");
    fflush(stderr);
}
int32_t dg_diploid_dp(int64_t nv, int64_t L, int32_t R,
                      const int64_t* level_ptr,
                      const int64_t* adj_ptr, const int32_t* adj_v,
                      const int8_t* adj_w,
                      const int64_t* hom_ptr, const int32_t* hom_colors,
                      const int64_t* het_ptr, const int32_t* het_colors,
                      int64_t* out_shet, int32_t* out_trans,
                      int32_t n_threads, int32_t progress) {
#ifdef _OPENMP
    omp_set_num_threads(n_threads > 0 ? n_threads : 1);
#endif
    const int32_t NEG_INF = INT32_MIN / 4;
    const int32_t W = R + 1;
    if (R < 0) return INT32_MIN;

    // backpointer store: per level l (1..L-1), packed int32 per state:
    // pi | pj<<12 | wu<<24 | wv<<25 — requires every level width < 4096;
    // validate up front rather than silently corrupting backpointers.
    for (int64_t l = 0; l < L; l++)
        if (level_ptr[l + 1] - level_ptr[l] >= 4096) return INT32_MIN;
    std::vector<std::vector<int32_t>> bp(L);

    int32_t k0 = (int32_t)(level_ptr[1] - level_ptr[0]);
    std::vector<int32_t> val((size_t)W * k0 * k0, 0);
    std::vector<int64_t> shet((size_t)W * k0 * k0, 0);

    // scratch reused across levels
    std::vector<uint64_t> lmask_h, lmask_t, rmask_h, rmask_t;
    std::vector<int32_t> pred_ptr, pred_i, pred_w;
    std::vector<int32_t> nval_buf;
    std::vector<int64_t> nshet_buf;
    int32_t max_color = -1;
    for (int64_t c = 0; c < hom_ptr[nv]; c++)
        max_color = std::max(max_color, hom_colors[c]);
    for (int64_t c = 0; c < het_ptr[nv]; c++)
        max_color = std::max(max_color, het_colors[c]);
    std::vector<int32_t> cstamp(max_color + 1, -1), clocal(max_color + 1);
    int32_t stamp_version = -1;

    int progress_next_pct = 0;
    const double progress_t0 = dg_wall_now();

    for (int64_t l = 0; l + 1 < L; l++) {
        const int64_t b0 = level_ptr[l], b1 = level_ptr[l + 1], b2 = level_ptr[l + 2];
        const int32_t k = (int32_t)(b1 - b0);
        const int32_t k2 = (int32_t)(b2 - b1);

        // ---- local colour re-indexing over levels l and l+1 ----
        // stamp-versioned remap table (O(1) per colour, no hashing)
        int32_t n_local = 0;
        ++stamp_version;
        auto local_id = [&](int32_t c) {
            if (cstamp[c] != stamp_version) {
                cstamp[c] = stamp_version;
                clocal[c] = n_local++;
            }
            return clocal[c];
        };
        for (int64_t v = b0; v < b2; v++) {
            for (int64_t c = hom_ptr[v]; c < hom_ptr[v + 1]; c++)
                local_id(hom_colors[c]);
            for (int64_t c = het_ptr[v]; c < het_ptr[v + 1]; c++)
                local_id(het_colors[c]);
        }
        const int32_t nwords = (n_local + 63) / 64;

        auto fill_masks = [&](int64_t vstart, int32_t cnt,
                              std::vector<uint64_t>& mh, std::vector<uint64_t>& mt) {
            mh.assign((size_t)cnt * nwords, 0);
            mt.assign((size_t)cnt * nwords, 0);
            for (int32_t i = 0; i < cnt; i++) {
                int64_t v = vstart + i;
                for (int64_t c = hom_ptr[v]; c < hom_ptr[v + 1]; c++) {
                    int32_t lc = local_id(hom_colors[c]);
                    mh[(size_t)i * nwords + lc / 64] |= 1ULL << (lc % 64);
                }
                for (int64_t c = het_ptr[v]; c < het_ptr[v + 1]; c++) {
                    int32_t lc = local_id(het_colors[c]);
                    mt[(size_t)i * nwords + lc / 64] |= 1ULL << (lc % 64);
                }
            }
        };
        fill_masks(b0, k, lmask_h, lmask_t);
        fill_masks(b1, k2, rmask_h, rmask_t);

        // ---- predecessor lists for level l+1 (reverse edges) ----
        pred_ptr.assign(k2 + 1, 0);
        for (int32_t i = 0; i < k; i++) {
            int64_t v = b0 + i;
            for (int64_t e = adj_ptr[v]; e < adj_ptr[v + 1]; e++)
                pred_ptr[adj_v[e] - b1 + 1]++;
        }
        for (int32_t i = 0; i < k2; i++) pred_ptr[i + 1] += pred_ptr[i];
        pred_i.assign(pred_ptr[k2], 0);
        pred_w.assign(pred_ptr[k2], 0);
        {
            std::vector<int32_t> fill(pred_ptr.begin(), pred_ptr.end() - 1);
            for (int32_t i = 0; i < k; i++) {
                int64_t v = b0 + i;
                for (int64_t e = adj_ptr[v]; e < adj_ptr[v + 1]; e++) {
                    int32_t t = adj_v[e] - (int32_t)b1;
                    pred_i[fill[t]] = i;
                    pred_w[fill[t]] = adj_w[e];
                    fill[t]++;
                }
            }
        }

        nval_buf.assign((size_t)W * k2 * k2, NEG_INF);
        nshet_buf.assign((size_t)W * k2 * k2, 0);
        bp[l + 1].assign((size_t)W * k2 * k2, -1);
        int32_t* bpl = bp[l + 1].data();
        int32_t* nval = nval_buf.data();
        int64_t* nshet = nshet_buf.data();

        struct Cand {
            int32_t i, j, wu, wv, score, symd;
        };

        // sparse word supports: scoring cost scales with the nonzero
        // bitset words of the participating vertices, not the whole
        // level-pair colour universe. Uses
        // |A △ B| = |A| + |B| − 2|A ∩ B| so only intersections (over the
        // right side's support) plus precomputed popcounts are needed.
        //   cntTL[i][j] (popcount of Tl_i|Tl_j) is computed per (i,j)
        //   lazily over the union of the two vertices' supports.
        std::vector<int32_t> lsup_ptr(k + 1, 0), rsup_ptr(k2 + 1, 0);
        std::vector<int32_t> lsup, rsup;  // word indices with any bits
        std::vector<int32_t> lcnt_t(k, 0);  // popcount(Tl_i) per left vertex
        for (int32_t i = 0; i < k; i++) {
            const uint64_t* lh_i = &lmask_h[(size_t)i * nwords];
            const uint64_t* lt_i = &lmask_t[(size_t)i * nwords];
            for (int32_t t = 0; t < nwords; t++) {
                if (lh_i[t] | lt_i[t]) lsup.push_back(t);
                lcnt_t[i] += __builtin_popcountll(lt_i[t]);
            }
            lsup_ptr[i + 1] = (int32_t)lsup.size();
        }
        for (int32_t i = 0; i < k2; i++) {
            const uint64_t* rh_i = &rmask_h[(size_t)i * nwords];
            const uint64_t* rt_i = &rmask_t[(size_t)i * nwords];
            for (int32_t t = 0; t < nwords; t++)
                if (rh_i[t] | rt_i[t]) rsup.push_back(t);
            rsup_ptr[i + 1] = (int32_t)rsup.size();
        }

#pragma omp parallel
        {
            std::vector<Cand> cands;
            std::vector<int32_t> rwords;  // merged support of (i2, j2)
            // per-thread r-indexed reduction scratch (heap: any R)
            std::vector<int32_t> best(W), bi(W), bj(W), bbp(W);
            std::vector<int64_t> bsh(W);
#pragma omp for schedule(dynamic, 1)
            for (int32_t i2 = 0; i2 < k2; i2++) {
                const uint64_t* rh2 = &rmask_h[(size_t)i2 * nwords];
                const uint64_t* rt2 = &rmask_t[(size_t)i2 * nwords];
                for (int32_t j2 = 0; j2 < k2; j2++) {
                    const uint64_t* rhj = &rmask_h[(size_t)j2 * nwords];
                    const uint64_t* rtj = &rmask_t[(size_t)j2 * nwords];
                    // merged sparse support of the right union
                    rwords.clear();
                    {
                        int32_t a = rsup_ptr[i2], ae = rsup_ptr[i2 + 1];
                        int32_t b = rsup_ptr[j2], be = rsup_ptr[j2 + 1];
                        while (a < ae || b < be) {
                            int32_t wa = a < ae ? rsup[a] : INT32_MAX;
                            int32_t wb = b < be ? rsup[b] : INT32_MAX;
                            int32_t wmin = wa < wb ? wa : wb;
                            rwords.push_back(wmin);
                            if (wa == wmin) a++;
                            if (wb == wmin) b++;
                        }
                    }
                    int32_t cnt_tr = 0;
                    for (int32_t t : rwords)
                        cnt_tr += __builtin_popcountll(rt2[t] | rtj[t]);

                    // hoist r-independent candidate scores
                    cands.clear();
                    for (int32_t pe = pred_ptr[i2]; pe < pred_ptr[i2 + 1]; pe++) {
                        const int32_t i = pred_i[pe];
                        const int32_t wu = pred_w[pe];
                        const uint64_t* lh_i = &lmask_h[(size_t)i * nwords];
                        const uint64_t* lt_i = &lmask_t[(size_t)i * nwords];
                        for (int32_t qe = pred_ptr[j2]; qe < pred_ptr[j2 + 1];
                             qe++) {
                            const int32_t j = pred_i[qe];
                            const int32_t wv = pred_w[qe];
                            const uint64_t* lh_j = &lmask_h[(size_t)j * nwords];
                            const uint64_t* lt_j = &lmask_t[(size_t)j * nwords];
                            // cnt(Tl_i | Tl_j) over the union of supports
                            int32_t cnt_tl;
                            if (i == j) {
                                cnt_tl = lcnt_t[i];
                            } else {
                                cnt_tl = 0;
                                int32_t a = lsup_ptr[i], ae = lsup_ptr[i + 1];
                                int32_t b = lsup_ptr[j], be = lsup_ptr[j + 1];
                                while (a < ae || b < be) {
                                    int32_t wa = a < ae ? lsup[a] : INT32_MAX;
                                    int32_t wb = b < be ? lsup[b] : INT32_MAX;
                                    int32_t t = wa < wb ? wa : wb;
                                    cnt_tl += __builtin_popcountll(
                                        lt_i[t] | lt_j[t]);
                                    if (wa == t) a++;
                                    if (wb == t) b++;
                                }
                            }
                            int32_t inter = 0, and_t = 0;
                            for (int32_t t : rwords) {
                                inter += __builtin_popcountll(
                                    (lh_i[t] | lh_j[t]) & (rh2[t] | rhj[t]));
                                and_t += __builtin_popcountll(
                                    (lt_i[t] | lt_j[t]) & (rt2[t] | rtj[t]));
                            }
                            const int32_t symd = cnt_tl + cnt_tr - 2 * and_t;
                            cands.push_back({i, j, wu, wv, inter + symd, symd});
                        }
                    }
                    // candidate-outer, r-inner over r-contiguous state
                    for (int32_t r2 = 0; r2 <= R; r2++) {
                        best[r2] = NEG_INF;
                        bi[r2] = INT32_MAX;
                        bj[r2] = INT32_MAX;
                        bbp[r2] = -1;
                        bsh[r2] = 0;
                    }
                    for (const Cand& c : cands) {
                        const int32_t wsum = c.wu + c.wv;
                        const int32_t* src =
                            &val[((size_t)c.i * k + c.j) * W];
                        const int64_t* ssh =
                            &shet[((size_t)c.i * k + c.j) * W];
                        const int32_t pk =
                            c.i | (c.j << 12) | (c.wu << 24) | (c.wv << 25);
                        for (int32_t r2 = wsum; r2 <= R; r2++) {
                            const int32_t sv = src[r2 - wsum];
                            if (sv == NEG_INF) continue;
                            const int32_t candv = sv + c.score;
                            if (candv > best[r2] ||
                                (candv == best[r2] &&
                                 (c.i < bi[r2] ||
                                  (c.i == bi[r2] && c.j < bj[r2])))) {
                                best[r2] = candv;
                                bi[r2] = c.i;
                                bj[r2] = c.j;
                                bbp[r2] = pk;
                                bsh[r2] = ssh[r2 - wsum] + c.symd;
                            }
                        }
                    }
                    const size_t base_di = ((size_t)i2 * k2 + j2) * W;
                    for (int32_t r2 = 0; r2 <= R; r2++) {
                        if (best[r2] != NEG_INF) {
                            nval[base_di + r2] = best[r2];
                            nshet[base_di + r2] = bsh[r2];
                            bpl[base_di + r2] = bbp[r2];
                        }
                    }
                }
            }
        }
        val.swap(nval_buf);
        shet.swap(nshet_buf);
        if (progress) {
            // 1%-throttled live bar with it/s + ETA
            // (reference: approximator.cpp:326-350, 550-557)
            const int pct = (int)(((long long)(l + 1) * 100) / L);
            if (l == 1 || pct >= progress_next_pct || l + 1 == L - 1) {
                dg_progress_bar((size_t)(l + 1), (size_t)L, progress_t0);
                while (progress_next_pct <= pct) progress_next_pct += 1;
            }
        }
    }
    if (progress) dg_progress_bar((size_t)L, (size_t)L, progress_t0);

    // ---- backtrack from (r=R, 0, 0) at the last level ----
    int32_t k_last = (int32_t)(level_ptr[L] - level_ptr[L - 1]);
    (void)k_last;
    int32_t sink_val = val[R];  // sink level has width 1, layout [i][j][r]
    *out_shet = shet[R];
    int32_t i2 = 0, j2 = 0, r2 = R;
    for (int64_t l = L - 1; l >= 1; l--) {
        const int32_t kk2 = (int32_t)(level_ptr[l + 1] - level_ptr[l]);
        const size_t di = ((size_t)i2 * kk2 + j2) * W + r2;
        int32_t packed = bp[l][di];
        int32_t pi = packed & 0xFFF;
        int32_t pj = (packed >> 12) & 0xFFF;
        int32_t wu = (packed >> 24) & 1;
        int32_t wv = (packed >> 25) & 1;
        out_trans[5 * l + 0] = pi;
        out_trans[5 * l + 1] = pj;
        out_trans[5 * l + 2] = r2 - wu - wv;
        out_trans[5 * l + 3] = wu;
        out_trans[5 * l + 4] = wv;
        i2 = pi; j2 = pj; r2 = r2 - wu - wv;
    }
    return sink_val;
}

// ---------------------------------------------------------------------------
// Strict BFS levelization (ExpandedGraph.hpp:269-409 semantics) over CSR.
//
// Same algorithm as graph/expanded.py strict_bfs_levelize_and_reorder:
// unique-source check, BFS distances, Kahn topo, level relaxation, dummy
// chains so every edge spans one level, stable (level, id) reorder.
// Results are kept in static storage; call dg_levelize_run, query sizes,
// then dg_levelize_fetch. src_old[v] gives the pre-levelize vertex a
// final vertex derives from (dummies inherit their chain head, matching
// add_dummy's original_vertex inheritance); is_dummy flags them.
// ---------------------------------------------------------------------------
namespace {
struct LevelizeResult {
    std::vector<int32_t> level, src_old, adj_v;
    std::vector<int8_t> is_dummy, adj_w;
    std::vector<int64_t> adj_ptr, level_ptr;
    int32_t max_width = 0;
};
LevelizeResult g_lv;
}  // namespace

int32_t dg_levelize_run(int64_t n0, const int64_t* adj_ptr,
                        const int32_t* adj_v, const int8_t* adj_w) {
    if (n0 == 0) return -1;
    std::vector<int32_t> indeg(n0, 0);
    for (int64_t e = 0; e < adj_ptr[n0]; e++) indeg[adj_v[e]]++;
    int64_t source = -1;
    for (int64_t v = 0; v < n0; v++) {
        if (indeg[v] == 0 && adj_ptr[v + 1] > adj_ptr[v]) {
            if (source == -1) source = v;
            else return -2;  // multiple sources
        }
    }
    if (source < 0) return -3;

    // BFS distances
    std::vector<int32_t> dist(n0, -1);
    std::vector<int64_t> queue;
    queue.reserve(n0);
    dist[source] = 0;
    queue.push_back(source);
    for (size_t qi = 0; qi < queue.size(); qi++) {
        int64_t u = queue[qi];
        for (int64_t e = adj_ptr[u]; e < adj_ptr[u + 1]; e++) {
            int32_t v = adj_v[e];
            if (dist[v] == -1) {
                dist[v] = dist[u] + 1;
                queue.push_back(v);
            }
        }
    }

    // Kahn topo
    std::vector<int32_t> indeg2(indeg);
    std::vector<int64_t> topo;
    topo.reserve(n0);
    for (int64_t v = 0; v < n0; v++)
        if (indeg2[v] == 0) topo.push_back(v);
    for (size_t ti = 0; ti < topo.size(); ti++) {
        int64_t u = topo[ti];
        for (int64_t e = adj_ptr[u]; e < adj_ptr[u + 1]; e++)
            if (--indeg2[adj_v[e]] == 0) topo.push_back(adj_v[e]);
    }
    if ((int64_t)topo.size() != n0) return -4;  // cycle

    // level relaxation
    std::vector<int32_t> lvl(n0, 0);
    for (int64_t v = 0; v < n0; v++)
        if (dist[v] >= 0) lvl[v] = dist[v];
    for (int64_t u : topo)
        for (int64_t e = adj_ptr[u]; e < adj_ptr[u + 1]; e++)
            if (lvl[adj_v[e]] <= lvl[u]) lvl[adj_v[e]] = lvl[u] + 1;

    // dummies: pre-count then fill
    std::vector<int32_t> tmp_lvl(lvl);
    std::vector<int32_t> src_old;
    std::vector<int8_t> dummy_flag(n0, 0);
    src_old.reserve(n0);
    for (int64_t v = 0; v < n0; v++) src_old.push_back((int32_t)v);

    struct Edge { int32_t u, v; int8_t w; };
    std::vector<Edge> edges;
    edges.reserve(adj_ptr[n0] * 2);
    for (int64_t u = 0; u < n0; u++) {
        for (int64_t e = adj_ptr[u]; e < adj_ptr[u + 1]; e++) {
            int32_t v = adj_v[e];
            int32_t gap = tmp_lvl[v] - tmp_lvl[u] - 1;
            if (gap <= 0) {
                edges.push_back({(int32_t)u, v, adj_w[e]});
            } else {
                int32_t prev = (int32_t)u;
                for (int32_t step = 1; step <= gap; step++) {
                    int32_t dummy = (int32_t)src_old.size();
                    src_old.push_back((int32_t)u);
                    dummy_flag.push_back(1);
                    tmp_lvl.push_back(tmp_lvl[u] + step);
                    edges.push_back({prev, dummy, (int8_t)(step == 1 ? adj_w[e] : 0)});
                    prev = dummy;
                }
                edges.push_back({prev, v, 0});
            }
        }
    }
    const int64_t n1 = (int64_t)src_old.size();

    // stable order by (level, id)
    std::vector<int32_t> order(n1);
    for (int64_t i = 0; i < n1; i++) order[i] = (int32_t)i;
    std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
        return tmp_lvl[a] != tmp_lvl[b] ? tmp_lvl[a] < tmp_lvl[b] : a < b;
    });
    std::vector<int32_t> new_id(n1);
    for (int64_t i = 0; i < n1; i++) new_id[order[i]] = (int32_t)i;

    g_lv.level.resize(n1);
    g_lv.src_old.resize(n1);
    g_lv.is_dummy.resize(n1);
    for (int64_t i = 0; i < n1; i++) {
        int32_t old = order[i];
        g_lv.level[i] = tmp_lvl[old];
        g_lv.src_old[i] = src_old[old];
        g_lv.is_dummy[i] = dummy_flag[old];
    }
    // CSR of remapped edges, per-source order preserved
    std::vector<int32_t> deg(n1, 0);
    for (auto& e : edges) deg[new_id[e.u]]++;
    g_lv.adj_ptr.assign(n1 + 1, 0);
    for (int64_t i = 0; i < n1; i++) g_lv.adj_ptr[i + 1] = g_lv.adj_ptr[i] + deg[i];
    g_lv.adj_v.resize(edges.size());
    g_lv.adj_w.resize(edges.size());
    {
        std::vector<int64_t> fill(g_lv.adj_ptr.begin(), g_lv.adj_ptr.end() - 1);
        // edges were generated in old-u order; per-source relative order is
        // the original adjacency order, which is what the reference keeps
        for (auto& e : edges) {
            int32_t u = new_id[e.u];
            g_lv.adj_v[fill[u]] = new_id[e.v];
            g_lv.adj_w[fill[u]] = e.w;
            fill[u]++;
        }
    }
    int32_t max_level = 0;
    for (int64_t i = 0; i < n1; i++) max_level = std::max(max_level, g_lv.level[i]);
    g_lv.level_ptr.assign(max_level + 2, 0);
    for (int64_t i = 0; i < n1; i++) g_lv.level_ptr[g_lv.level[i] + 1]++;
    for (int32_t l = 0; l <= max_level; l++) g_lv.level_ptr[l + 1] += g_lv.level_ptr[l];
    g_lv.max_width = 0;
    for (int32_t l = 0; l <= max_level; l++)
        g_lv.max_width = std::max(
            g_lv.max_width, (int32_t)(g_lv.level_ptr[l + 1] - g_lv.level_ptr[l]));
    return 0;
}

int64_t dg_levelize_n() { return (int64_t)g_lv.level.size(); }
int64_t dg_levelize_ne() { return (int64_t)g_lv.adj_v.size(); }
int64_t dg_levelize_nl() { return (int64_t)g_lv.level_ptr.size() - 1; }
int32_t dg_levelize_maxwidth() { return g_lv.max_width; }

void dg_levelize_fetch(int32_t* level, int32_t* src_old, int8_t* is_dummy,
                       int64_t* out_adj_ptr, int32_t* out_adj_v,
                       int8_t* out_adj_w, int64_t* out_level_ptr) {
    memcpy(level, g_lv.level.data(), g_lv.level.size() * 4);
    memcpy(src_old, g_lv.src_old.data(), g_lv.src_old.size() * 4);
    memcpy(is_dummy, g_lv.is_dummy.data(), g_lv.is_dummy.size());
    memcpy(out_adj_ptr, g_lv.adj_ptr.data(), g_lv.adj_ptr.size() * 8);
    memcpy(out_adj_v, g_lv.adj_v.data(), g_lv.adj_v.size() * 4);
    memcpy(out_adj_w, g_lv.adj_w.data(), g_lv.adj_w.size());
    memcpy(out_level_ptr, g_lv.level_ptr.data(), g_lv.level_ptr.size() * 8);
    LevelizeResult().level.swap(g_lv.level);  // release
    g_lv = LevelizeResult();
}

// ---------------------------------------------------------------------------
// std::sort permutation oracle.
//
// Two reference sorts run std::sort with comparators that can compare
// equal (anchor occurrences with identical spans): solver.cpp:641-663 and
// approximator.cpp:1200-1208. The relative order of such ties is decided
// by libstdc++'s introsort and is observable in the output. Sorting a
// permutation array with the same comparator reproduces the exact swap
// sequence, giving byte-identical downstream behavior.
// ---------------------------------------------------------------------------
void dg_std_sort3(const int64_t* k1, const int64_t* k2, const int64_t* k3,
                  int32_t* perm, int64_t n) {
    std::sort(perm, perm + n, [&](int32_t a, int32_t b) {
        if (k1[a] != k1[b]) return k1[a] < k1[b];
        if (k2[a] != k2[b]) return k2[a] < k2[b];
        return k3[a] < k3[b];
    });
}

// ---------------------------------------------------------------------------
// Streaming FASTA/FASTQ(.gz) reader — kseq equivalent (reference src/kseq.h,
// used by read_ip_reads solver.cpp:230-245). Parses the whole file into
// concatenated name / sequence blobs with offset tables; results live in
// static storage between _run and _fetch (single-threaded usage).
// ---------------------------------------------------------------------------
namespace {
struct FastxResult {
    std::string names, seqs;
    std::vector<int64_t> name_off{0}, seq_off{0};
};
FastxResult g_fx;
}  // namespace

int64_t dg_fastx_run(const char* path) {
    g_fx = FastxResult();
    gzFile fp = gzopen(path, "r");
    if (!fp) return -1;
    gzbuffer(fp, 1 << 20);
    std::string line;
    line.reserve(1 << 16);
    char buf[1 << 16];
    auto getline_gz = [&](std::string& out) -> bool {
        out.clear();
        while (true) {
            if (gzgets(fp, buf, sizeof(buf)) == nullptr) return !out.empty();
            out += buf;
            if (!out.empty() && out.back() == '\n') {
                out.pop_back();
                if (!out.empty() && out.back() == '\r') out.pop_back();
                return true;
            }
        }
    };

    std::string pending;
    bool has_pending = false;
    auto next_line = [&](std::string& out) -> bool {
        if (has_pending) {
            out = pending;
            has_pending = false;
            return true;
        }
        return getline_gz(out);
    };

    int64_t count = 0;
    std::string l;
    while (next_line(l)) {
        if (l.empty()) continue;
        if (l[0] == '@') {  // FASTQ record
            size_t sp = l.find_first_of(" \t");
            g_fx.names += l.substr(1, sp == std::string::npos ? l.size() - 1
                                                              : sp - 1);
            g_fx.name_off.push_back((int64_t)g_fx.names.size());
            int64_t seq_len = 0;
            std::string l2;
            while (getline_gz(l2)) {
                if (!l2.empty() && l2[0] == '+') {
                    int64_t got = 0;  // skip quality of equal length
                    while (got < seq_len && getline_gz(l2))
                        got += (int64_t)l2.size();
                    break;
                }
                g_fx.seqs += l2;
                seq_len += (int64_t)l2.size();
            }
            g_fx.seq_off.push_back((int64_t)g_fx.seqs.size());
            count++;
        } else if (l[0] == '>') {  // FASTA record
            size_t sp = l.find_first_of(" \t");
            g_fx.names += l.substr(1, sp == std::string::npos ? l.size() - 1
                                                              : sp - 1);
            g_fx.name_off.push_back((int64_t)g_fx.names.size());
            std::string l2;
            while (getline_gz(l2)) {
                if (!l2.empty() && (l2[0] == '>' || l2[0] == '@')) {
                    pending = l2;
                    has_pending = true;
                    break;
                }
                g_fx.seqs += l2;
            }
            g_fx.seq_off.push_back((int64_t)g_fx.seqs.size());
            count++;
        }
    }
    gzclose(fp);
    return count;
}

int64_t dg_fastx_names_len() { return (int64_t)g_fx.names.size(); }
int64_t dg_fastx_seqs_len() { return (int64_t)g_fx.seqs.size(); }

void dg_fastx_fetch(uint8_t* names, uint8_t* seqs, int64_t* name_off,
                    int64_t* seq_off) {
    memcpy(names, g_fx.names.data(), g_fx.names.size());
    memcpy(seqs, g_fx.seqs.data(), g_fx.seqs.size());
    memcpy(name_off, g_fx.name_off.data(), g_fx.name_off.size() * 8);
    memcpy(seq_off, g_fx.seq_off.data(), g_fx.seq_off.size() * 8);
    g_fx = FastxResult();
}

// ---------------------------------------------------------------------------
// Anchor stage (solver.cpp:563-663 semantics): per-haplotype hash join of
// minimizers against the read spectrum, vertex-chain construction
// (solver.cpp:336-358), the uninformativeness filter (solver.cpp:590-633)
// and the (first,last) occurrence sort (solver.cpp:641-663). Emits flat
// occurrence arrays ordered (spectrum id asc, hap asc, emission order) —
// exactly the iteration order of the reference's Anchor_hits loops — so
// the expanded-graph builder below can consume them directly.
// ---------------------------------------------------------------------------
namespace {
struct AnchorStage {
    std::vector<int32_t> occ_sp, occ_hap, occ_v;
    std::vector<int64_t> occ_ptr;
    std::vector<int64_t> hap_counts;
    int64_t n_filtered = 0;
};
AnchorStage g_anc;
}  // namespace

int32_t dg_anchor_run(
    int64_t n_vtx, int32_t nH,
    const int64_t* min_ptr, const uint64_t* min_hash, const int64_t* min_pos,
    const uint64_t* sp_hashes, int64_t S,
    const int64_t* path_ptr, const int32_t* path_v,
    const int64_t* node_len, const int64_t* tom,
    int32_t k, double threshold) {
    g_anc = AnchorStage();
    g_anc.hap_counts.assign(nH, 0);

    struct Occ {
        int32_t sp, hap;
        std::vector<int32_t> chain;
    };
    std::vector<Occ> occs;

    std::vector<int64_t> cum;
    std::vector<int32_t> chain;
    for (int32_t h = 0; h < nH; h++) {
        const int64_t plen = path_ptr[h + 1] - path_ptr[h];
        const int32_t* pv = path_v + path_ptr[h];
        cum.assign(plen + 1, 0);
        for (int64_t i = 0; i < plen; i++)
            cum[i + 1] = cum[i] + node_len[pv[i]];
        for (int64_t m = min_ptr[h]; m < min_ptr[h + 1]; m++) {
            const uint64_t hh = min_hash[m];
            const uint64_t* it =
                std::lower_bound(sp_hashes, sp_hashes + S, hh);
            if (it == sp_hashes + S || *it != hh) continue;
            const int32_t sp = (int32_t)(it - sp_hashes);
            const int64_t pos = min_pos[m];
            // path step containing base offset pos / pos+k-1
            // (upper_bound(cum, x) - 1 over starts; matches np.repeat map)
            auto step_of = [&](int64_t x) {
                return (int64_t)(std::upper_bound(cum.begin(), cum.end(), x) -
                                 cum.begin()) - 1;
            };
            const int64_t t0 = step_of(pos);
            const int64_t t1 = step_of(pos + k - 1);
            chain.clear();
            for (int64_t t = t0; t <= t1; t++) {
                int32_t v = pv[t];
                bool seen = false;
                for (int32_t c : chain)
                    if (c == v) { seen = true; break; }
                if (!seen) chain.push_back(v);
            }
            std::sort(chain.begin(), chain.end(),
                      [&](int32_t a, int32_t b) { return tom[a] < tom[b]; });
            occs.push_back({sp, h, chain});
        }
    }

    // group by spectrum id, keeping (hap asc, emission) inside each group
    std::vector<int64_t> order(occs.size());
    for (size_t i = 0; i < order.size(); i++) order[i] = (int64_t)i;
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return occs[a].sp < occs[b].sp;
    });

    const double cutoff = threshold * (double)nH;
    g_anc.occ_ptr.push_back(0);
    size_t gi = 0;
    while (gi < order.size()) {
        size_t ge = gi;
        const int32_t sp = occs[order[gi]].sp;
        while (ge < order.size() && occs[order[ge]].sp == sp) ge++;
        // uninformativeness filter: any identical chain >= threshold*H times
        bool drop = false;
        for (size_t a = gi; a < ge && !drop; a++) {
            int32_t cnt = 0;
            for (size_t b = gi; b < ge; b++)
                if (occs[order[b]].chain == occs[order[a]].chain) cnt++;
            if ((double)cnt >= cutoff) drop = true;
        }
        if (drop) {
            g_anc.n_filtered++;
            gi = ge;
            continue;
        }
        // per-hap std::sort by (empty-last, first, last); introsort tie
        // order matches the reference (and the Python stdsort oracle)
        size_t hi = gi;
        while (hi < ge) {
            size_t he = hi;
            const int32_t hap = occs[order[hi]].hap;
            while (he < ge && occs[order[he]].hap == hap) he++;
            std::sort(order.begin() + hi, order.begin() + he,
                      [&](int64_t a, int64_t b) {
                          const auto& ca = occs[a].chain;
                          const auto& cb = occs[b].chain;
                          const int64_t e_a = ca.empty(), e_b = cb.empty();
                          if (e_a != e_b) return e_a < e_b;
                          const int64_t f_a = ca.empty() ? 0 : ca.front();
                          const int64_t f_b = cb.empty() ? 0 : cb.front();
                          if (f_a != f_b) return f_a < f_b;
                          const int64_t l_a = ca.empty() ? 0 : ca.back();
                          const int64_t l_b = cb.empty() ? 0 : cb.back();
                          return l_a < l_b;
                      });
            hi = he;
        }
        for (size_t a = gi; a < ge; a++) {
            const Occ& o = occs[order[a]];
            g_anc.occ_sp.push_back(o.sp);
            g_anc.occ_hap.push_back(o.hap);
            g_anc.occ_v.insert(g_anc.occ_v.end(), o.chain.begin(),
                               o.chain.end());
            g_anc.occ_ptr.push_back((int64_t)g_anc.occ_v.size());
            g_anc.hap_counts[o.hap]++;
        }
        gi = ge;
    }
    (void)n_vtx;
    return 0;
}

int64_t dg_anchor_nocc() { return (int64_t)g_anc.occ_sp.size(); }
int64_t dg_anchor_nv() { return (int64_t)g_anc.occ_v.size(); }
int64_t dg_anchor_nfiltered() { return g_anc.n_filtered; }

void dg_anchor_fetch(int32_t* occ_sp, int32_t* occ_hap, int64_t* occ_ptr,
                     int32_t* occ_v, int64_t* hap_counts) {
    memcpy(occ_sp, g_anc.occ_sp.data(), g_anc.occ_sp.size() * 4);
    memcpy(occ_hap, g_anc.occ_hap.data(), g_anc.occ_hap.size() * 4);
    memcpy(occ_ptr, g_anc.occ_ptr.data(), g_anc.occ_ptr.size() * 8);
    memcpy(occ_v, g_anc.occ_v.data(), g_anc.occ_v.size() * 4);
    memcpy(hap_counts, g_anc.hap_counts.data(), g_anc.hap_counts.size() * 8);
    g_anc = AnchorStage();
}

// ---------------------------------------------------------------------------
// Expanded-graph construction + Kahn topological reorder
// (Approximator::solve steps, approximator.cpp:1017-1246, and
// ExpandedGraph::topologically_reorder, ExpandedGraph.hpp:29-102).
//
// Consumes the flat occurrence arrays from dg_anchor_run (or flattened
// Python anchor_hits): (sp asc, hap asc, emission order). Produces the
// reordered graph as CSR plus the per-hap post-sweep anchor tables the
// diploid stitcher needs (startOrg, endOrg, colours).
// ---------------------------------------------------------------------------
namespace {
struct BuildResult {
    std::vector<int64_t> adj_ptr;
    std::vector<int32_t> adj_v;
    std::vector<int8_t> adj_w;
    std::vector<int64_t> col_ptr, org_ptr;
    std::vector<int32_t> col_v, org_v;
    std::vector<int32_t> hap;
    std::vector<int32_t> color_to_anchor;
    std::vector<int64_t> anc_ptr;  // per-hap anchor offsets [nH+1]
    std::vector<int32_t> anc_so, anc_eo;
    std::vector<int64_t> anc_cptr;
    std::vector<int32_t> anc_cv;
    int64_t sink = -1;
    int32_t num_colors = 0;
};
BuildResult g_bd;
}  // namespace

int32_t dg_build_run(
    int64_t n_vtx, int32_t nH,
    const int64_t* path_ptr, const int32_t* path_v,
    const int64_t* oadj_ptr, const int32_t* oadj_v,
    int64_t n_occ, const int32_t* occ_sp, const int32_t* occ_hap,
    const int64_t* occ_ptr, const int32_t* occ_v) {
    g_bd = BuildResult();

    typedef std::pair<int32_t, int8_t> E;
    const int64_t NV = path_ptr[nH];
    std::vector<std::vector<E>> adj(2 + NV);
    // vertex_to_expanded[v*nH + h]
    std::vector<int32_t> v2e((size_t)n_vtx * nH, -1);
    std::vector<std::vector<int32_t>> e2o(2 + NV);
    std::vector<int32_t> v2h(2 + NV, 0);
    const int32_t sink = (int32_t)(1 + NV);

    // per-hap chains + source/sink (approximator.cpp:1029-1049)
    int32_t cur = 1;
    for (int32_t h = 0; h < nH; h++) {
        adj[0].push_back({cur, 0});
        const int64_t plen = path_ptr[h + 1] - path_ptr[h];
        const int32_t* pv = path_v + path_ptr[h];
        for (int64_t i = 0; i < plen; i++) {
            const int32_t v = pv[i];
            v2e[(size_t)v * nH + h] = cur;
            e2o[cur].push_back(v);
            v2h[cur] = h;
            if (i < plen - 1)
                adj[cur].push_back({cur + 1, 0});
            else
                adj[cur].push_back({sink, 0});
            cur++;
        }
    }

    // recombination w-vertices (approximator.cpp:1051-1095)
    std::vector<int32_t> w_id(oadj_ptr[n_vtx], -1);
    cur = (int32_t)adj.size();
    for (int32_t h = 0; h < nH; h++) {
        const int64_t plen = path_ptr[h + 1] - path_ptr[h];
        const int32_t* pv = path_v + path_ptr[h];
        for (int64_t i = 0; i < plen; i++) {
            const int32_t u = pv[i];
            const int32_t nxt = (i < plen - 1) ? pv[i + 1] : -1;
            for (int64_t e = oadj_ptr[u]; e < oadj_ptr[u + 1]; e++) {
                const int32_t v = oadj_v[e];
                if (i == plen - 1 || v != nxt) {
                    if (w_id[e] == -1) {
                        adj.emplace_back();
                        e2o.emplace_back();
                        v2h.push_back(-1);
                        w_id[e] = cur++;
                    }
                    adj[v2e[(size_t)u * nH + h]].push_back({w_id[e], 1});
                    if (adj[w_id[e]].empty()) {
                        for (int32_t h2 = 0; h2 < nH; h2++) {
                            const int32_t ve = v2e[(size_t)v * nH + h2];
                            if (ve >= 0) adj[w_id[e]].push_back({ve, 0});
                        }
                    }
                }
            }
        }
    }

    // anchor super-nodes + colours (approximator.cpp:1114-1176)
    struct ARec {
        int32_t startOrg, endOrg, startExp, endExp, nodeID;
        std::vector<int32_t> colours;
    };
    std::vector<std::vector<int32_t>> color(adj.size());
    std::vector<std::vector<ARec>> anchors_by_hap(nH);
    int32_t next_id = (int32_t)adj.size();
    int32_t colour_id = 0;
    int64_t oi = 0;
    while (oi < n_occ) {
        const int32_t sp = occ_sp[oi];
        bool new_color_used = false;
        for (; oi < n_occ && occ_sp[oi] == sp; oi++) {
            const int64_t c0 = occ_ptr[oi], c1 = occ_ptr[oi + 1];
            if (c0 == c1) continue;
            const int32_t h = occ_hap[oi];
            new_color_used = true;
            const int32_t start_org = occ_v[c0];
            const int32_t end_org = occ_v[c1 - 1];
            const int32_t start_exp = v2e[(size_t)start_org * nH + h];
            const int32_t end_exp = v2e[(size_t)end_org * nH + h];
            int32_t node_id;
            if (start_exp == end_exp) {
                node_id = start_exp;
            } else {
                adj[start_exp].push_back({next_id, 0});
                adj.emplace_back();
                adj.back().push_back({end_exp, 0});
                e2o.emplace_back(occ_v + c0, occ_v + c1);
                color.emplace_back();
                v2h.push_back(-1);
                node_id = next_id++;
            }
            anchors_by_hap[h].push_back(
                {start_org, end_org, start_exp, end_exp, node_id,
                 {colour_id}});
        }
        if (new_color_used) {
            g_bd.color_to_anchor.push_back(sp);
            colour_id++;
        }
    }
    g_bd.num_colors = colour_id;

    // sweep per haplotype (approximator.cpp:1193-1246); std::sort on
    // (startExp, endExp) — libstdc++ tie order is observable via the
    // colour containment unions and matches the reference
    for (int32_t h = 0; h < nH; h++) {
        auto& vec = anchors_by_hap[h];
        if (vec.empty()) continue;
        std::sort(vec.begin(), vec.end(), [](const ARec& a, const ARec& b) {
            if (a.startExp != b.startExp) return a.startExp < b.startExp;
            return a.endExp < b.endExp;
        });
        std::vector<int64_t> stk;
        for (int64_t ai = 0; ai < (int64_t)vec.size(); ai++) {
            ARec& anc = vec[ai];
            while (!stk.empty() && vec[stk.back()].endExp < anc.startExp)
                stk.pop_back();
            if (!stk.empty() && anc.startExp <= vec[stk.back()].endExp &&
                vec[stk.back()].nodeID != anc.nodeID)
                adj[vec[stk.back()].nodeID].push_back({anc.nodeID, 0});
            for (int64_t i = (int64_t)stk.size() - 1; i >= 0; i--) {
                if (anc.endExp <= vec[stk[i]].endExp) {
                    auto& have = vec[stk[i]].colours;
                    for (int32_t c : anc.colours) {
                        bool got = false;
                        for (int32_t x : have)
                            if (x == c) { got = true; break; }
                        if (!got) have.push_back(c);
                    }
                } else {
                    break;
                }
            }
            stk.push_back(ai);
        }
        for (const ARec& anc : vec) {
            auto& dst = color[anc.nodeID];
            dst.insert(dst.end(), anc.colours.begin(), anc.colours.end());
            std::sort(dst.begin(), dst.end());
            dst.erase(std::unique(dst.begin(), dst.end()), dst.end());
        }
    }

    // ---- Kahn topological reorder, sink last (ExpandedGraph.hpp:29-102) ----
    const int64_t n = (int64_t)adj.size();
    std::vector<int32_t> indeg(n, 0);
    for (const auto& nbrs : adj)
        for (const E& e : nbrs) indeg[e.first]++;
    std::vector<int32_t> q;
    q.reserve(n);
    for (int64_t v = 0; v < n; v++)
        if (indeg[v] == 0 && v != sink) q.push_back((int32_t)v);
    bool sink_ready = indeg[sink] == 0;
    std::vector<int32_t> order;
    order.reserve(n);
    size_t qh = 0;
    while (qh < q.size() || sink_ready) {
        int32_t u;
        if (qh < q.size()) {
            u = q[qh++];
        } else {
            u = sink;
            sink_ready = false;
        }
        order.push_back(u);
        for (const E& e : adj[u]) {
            if (--indeg[e.first] == 0) {
                if (e.first == sink)
                    sink_ready = true;
                else
                    q.push_back(e.first);
            }
        }
    }
    if ((int64_t)order.size() != n) return -1;  // cycle
    std::vector<int32_t> new_idx(n);
    for (int64_t i = 0; i < n; i++) new_idx[order[i]] = (int32_t)i;

    // permuted CSR outputs (per-source edge order preserved)
    g_bd.adj_ptr.assign(n + 1, 0);
    g_bd.col_ptr.assign(n + 1, 0);
    g_bd.org_ptr.assign(n + 1, 0);
    g_bd.hap.resize(n);
    int64_t ne = 0, nc = 0, no = 0;
    for (int64_t i = 0; i < n; i++) {
        const int32_t old = order[i];
        ne += (int64_t)adj[old].size();
        nc += (int64_t)color[old].size();
        no += (int64_t)e2o[old].size();
        g_bd.adj_ptr[i + 1] = ne;
        g_bd.col_ptr[i + 1] = nc;
        g_bd.org_ptr[i + 1] = no;
        g_bd.hap[i] = v2h[old];
    }
    g_bd.adj_v.resize(ne);
    g_bd.adj_w.resize(ne);
    g_bd.col_v.resize(nc);
    g_bd.org_v.resize(no);
    for (int64_t i = 0; i < n; i++) {
        const int32_t old = order[i];
        int64_t p = g_bd.adj_ptr[i];
        for (const E& e : adj[old]) {
            g_bd.adj_v[p] = new_idx[e.first];
            g_bd.adj_w[p] = e.second;
            p++;
        }
        memcpy(g_bd.col_v.data() + g_bd.col_ptr[i], color[old].data(),
               color[old].size() * 4);
        memcpy(g_bd.org_v.data() + g_bd.org_ptr[i], e2o[old].data(),
               e2o[old].size() * 4);
    }
    g_bd.sink = new_idx[sink];

    // flattened per-hap anchor tables (sorted order, post-sweep colours)
    g_bd.anc_ptr.assign(nH + 1, 0);
    for (int32_t h = 0; h < nH; h++)
        g_bd.anc_ptr[h + 1] =
            g_bd.anc_ptr[h] + (int64_t)anchors_by_hap[h].size();
    g_bd.anc_cptr.push_back(0);
    for (int32_t h = 0; h < nH; h++) {
        for (const ARec& a : anchors_by_hap[h]) {
            g_bd.anc_so.push_back(a.startOrg);
            g_bd.anc_eo.push_back(a.endOrg);
            g_bd.anc_cv.insert(g_bd.anc_cv.end(), a.colours.begin(),
                               a.colours.end());
            g_bd.anc_cptr.push_back((int64_t)g_bd.anc_cv.size());
        }
    }
    return 0;
}

int64_t dg_build_n() { return (int64_t)g_bd.hap.size(); }
int64_t dg_build_ne() { return (int64_t)g_bd.adj_v.size(); }
int64_t dg_build_ncol() { return (int64_t)g_bd.col_v.size(); }
int64_t dg_build_norg() { return (int64_t)g_bd.org_v.size(); }
int64_t dg_build_sink() { return g_bd.sink; }
int32_t dg_build_ncolors() { return g_bd.num_colors; }
int64_t dg_build_nanc() { return (int64_t)g_bd.anc_so.size(); }
int64_t dg_build_nancv() { return (int64_t)g_bd.anc_cv.size(); }
int64_t dg_build_ncta() { return (int64_t)g_bd.color_to_anchor.size(); }

void dg_build_fetch(int64_t* adj_ptr, int32_t* adj_v, int8_t* adj_w,
                    int64_t* col_ptr, int32_t* col_v,
                    int64_t* org_ptr, int32_t* org_v, int32_t* hap,
                    int32_t* color_to_anchor, int64_t* anc_ptr,
                    int32_t* anc_so, int32_t* anc_eo,
                    int64_t* anc_cptr, int32_t* anc_cv) {
    memcpy(adj_ptr, g_bd.adj_ptr.data(), g_bd.adj_ptr.size() * 8);
    memcpy(adj_v, g_bd.adj_v.data(), g_bd.adj_v.size() * 4);
    memcpy(adj_w, g_bd.adj_w.data(), g_bd.adj_w.size());
    memcpy(col_ptr, g_bd.col_ptr.data(), g_bd.col_ptr.size() * 8);
    memcpy(col_v, g_bd.col_v.data(), g_bd.col_v.size() * 4);
    memcpy(org_ptr, g_bd.org_ptr.data(), g_bd.org_ptr.size() * 8);
    memcpy(org_v, g_bd.org_v.data(), g_bd.org_v.size() * 4);
    memcpy(hap, g_bd.hap.data(), g_bd.hap.size() * 4);
    memcpy(color_to_anchor, g_bd.color_to_anchor.data(),
           g_bd.color_to_anchor.size() * 4);
    memcpy(anc_ptr, g_bd.anc_ptr.data(), g_bd.anc_ptr.size() * 8);
    memcpy(anc_so, g_bd.anc_so.data(), g_bd.anc_so.size() * 4);
    memcpy(anc_eo, g_bd.anc_eo.data(), g_bd.anc_eo.size() * 4);
    memcpy(anc_cptr, g_bd.anc_cptr.data(), g_bd.anc_cptr.size() * 8);
    memcpy(anc_cv, g_bd.anc_cv.data(), g_bd.anc_cv.size() * 4);
    g_bd = BuildResult();
}

// ---------------------------------------------------------------------------
// GFA v1.1 parser (S/L/W + embedded FASTA), walk canonicalization and
// finalize — semantics of the reference's minigraph-derived C layer
// (src/gfa-io.cpp:214-508, src/gfa-base.cpp:75-430) as re-specified by
// the clean-room Python parser in dipgenie_tpu/io/gfa.py (the byte-level
// golden oracle for this code; tests assert native == Python on every
// fixture). Streaming gzip reader, flat-blob outputs for ctypes.
// ---------------------------------------------------------------------------
namespace {
constexpr int64_t GFA_INT32_MAX = 2147483647;

struct GfaResult {
    // offset tables are size n+1 with a leading 0 (fastx fetch convention)
    std::string names;  // concatenated segment names
    std::vector<int64_t> name_off{0};
    std::string seqs;  // concatenated sequences ("" when absent)
    std::vector<int64_t> seq_off{0};
    std::vector<int8_t> has_seq;
    std::vector<int64_t> seg_len;
    std::vector<int8_t> seg_del;
    std::vector<int64_t> arcs;  // 5 per arc: v, w, ov, ow, comp
    std::string wsamples;
    std::vector<int64_t> wsample_off{0};
    std::string wseqnames;
    std::vector<int64_t> wseqname_off{0};
    std::vector<int64_t> whap, wst, wen;
    std::vector<uint32_t> wv;  // concatenated walk vertices (seg<<1|rev)
    std::vector<int64_t> wv_off{0};
};
GfaResult g_gfa;

static bool is_int_str(const char* s, const char* e) {
    if (s >= e) return false;
    if (*s == '-') s++;
    if (s >= e) return false;
    for (; s < e; s++)
        if (*s < '0' || *s > '9') return false;
    return true;
}

// L-line overlap field (gfa-io.cpp:298-319 semantics; io/gfa.py:77-110)
static void parse_overlap(const char* s, const char* e, int64_t* ov,
                          int64_t* ow) {
    *ov = *ow = 0;
    if (e - s == 1 && *s == '*') return;
    if (s < e && *s == ':') {
        *ov = GFA_INT32_MAX;
        *ow = (s + 1 < e && s[1] >= '0' && s[1] <= '9') ? atoll(s + 1)
                                                        : GFA_INT32_MAX;
        return;
    }
    if (s < e && *s >= '0' && *s <= '9') {
        const char* i = s;
        while (i < e && *i >= '0' && *i <= '9') i++;
        if (i < e && *i >= 'A' && *i <= 'Z') {  // CIGAR
            int64_t a = 0, b = 0, num = 0;
            for (const char* p = s; p < e; p++) {
                if (*p >= '0' && *p <= '9') {
                    num = num * 10 + (*p - '0');
                } else {
                    if (*p == 'M' || *p == 'D' || *p == 'N') a += num;
                    if (*p == 'M' || *p == 'I' || *p == 'S') b += num;
                    num = 0;
                }
            }
            *ov = a;
            *ow = b;
            return;
        }
        if (i < e && *i == ':') {
            *ov = atoll(s);
            *ow = (i + 1 < e && i[1] >= '0' && i[1] <= '9') ? atoll(i + 1)
                                                            : GFA_INT32_MAX;
            return;
        }
        *ov = atoll(s);  // bare int, missing ow
        *ow = GFA_INT32_MAX;
    }
}
}  // namespace

int64_t dg_gfa_run(const char* path) {
    g_gfa = GfaResult();
    gzFile fp = gzopen(path, "r");
    if (!fp) return -1;
    gzbuffer(fp, 1 << 20);
    char buf[1 << 16];
    std::string line;
    auto getline_gz = [&](std::string& out) -> bool {
        out.clear();
        while (true) {
            if (gzgets(fp, buf, sizeof(buf)) == nullptr) return !out.empty();
            out += buf;
            if (!out.empty() && out.back() == '\n') {
                out.pop_back();
                return true;
            }
        }
    };

    std::unordered_map<std::string, int32_t> name2id;
    name2id.reserve(1 << 18);
    auto add_seg = [&](const std::string& nm) -> int32_t {
        auto it = name2id.find(nm);
        if (it != name2id.end()) return it->second;
        int32_t sid = (int32_t)g_gfa.seg_len.size();
        name2id.emplace(nm, sid);
        g_gfa.names += nm;
        g_gfa.name_off.push_back((int64_t)g_gfa.names.size());
        g_gfa.seq_off.push_back((int64_t)g_gfa.seqs.size());
        g_gfa.has_seq.push_back(0);
        g_gfa.seg_len.push_back(0);
        g_gfa.seg_del.push_back(0);
        return sid;
    };
    // sequences land in per-segment slots appended possibly out of order;
    // buffer them and rebuild the blob at the end
    std::vector<std::string> seq_by_seg;
    auto set_seq = [&](int32_t sid, std::string s) {
        if ((size_t)sid >= seq_by_seg.size()) seq_by_seg.resize(sid + 1);
        seq_by_seg[sid] = std::move(s);
        g_gfa.has_seq[sid] = 1;
        g_gfa.seg_len[sid] = (int64_t)seq_by_seg[sid].size();
    };

    bool is_fa = false;
    int32_t fa_sid = -1;
    std::string fa_seq;
    auto finish_fa = [&]() {
        if (fa_sid >= 0) {
            set_seq(fa_sid, fa_seq);
            fa_seq.clear();
            fa_sid = -1;
        }
    };

    std::vector<const char*> f;  // field starts
    std::vector<const char*> fe;  // field ends
    while (getline_gz(line)) {
        if (!line.empty() && line.back() == '\r') line.pop_back();
        if (!line.empty() && line[0] == '>') {  // embedded FASTA header
            is_fa = true;
            finish_fa();
            char nm[32];
            snprintf(nm, sizeof(nm), "s%zu", g_gfa.seg_len.size() + 1);
            fa_sid = add_seg(nm);
            continue;
        }
        if (is_fa) {
            if (line.size() >= 3 && line[1] == '\t') {
                finish_fa();
                is_fa = false;
            } else {
                fa_seq += line;
                continue;
            }
        }
        if (line.size() < 3 || line[1] != '\t') continue;
        char tag = line[0];
        if (tag != 'S' && tag != 'L' && tag != 'W') continue;
        f.clear();
        fe.clear();
        const char* p = line.c_str();
        const char* end = p + line.size();
        const char* st = p;
        for (const char* q = p; q <= end; q++) {
            if (q == end || *q == '\t') {
                f.push_back(st);
                fe.push_back(q);
                st = q + 1;
            }
        }
        auto fs = [&](size_t i) { return std::string(f[i], fe[i]); };
        if (tag == 'S') {
            if (f.size() < 3) continue;
            int32_t sid = add_seg(fs(1));
            if (fe[2] - f[2] == 1 && *f[2] == '*') {
                if ((size_t)sid < seq_by_seg.size()) seq_by_seg[sid].clear();
                g_gfa.has_seq[sid] = 0;
                g_gfa.seg_len[sid] = 0;
                for (size_t i = 3; i < f.size(); i++) {  // first LN:i: tag
                    if (fe[i] - f[i] > 5 && !strncmp(f[i], "LN:i:", 5)) {
                        g_gfa.seg_len[sid] = atoll(f[i] + 5);
                        break;
                    }
                }
            } else {
                set_seq(sid, fs(2));
            }
        } else if (tag == 'L') {
            if (f.size() < 5) continue;
            char ov_c = *f[2], ow_c = *f[4];
            if ((ov_c != '+' && ov_c != '-') || (ow_c != '+' && ow_c != '-'))
                continue;
            if (fe[2] - f[2] != 1 || fe[4] - f[4] != 1) continue;
            int64_t ov = 0, ow = 0;
            if (f.size() > 5) parse_overlap(f[5], fe[5], &ov, &ow);
            int64_t v = ((int64_t)add_seg(fs(1)) << 1) | (ov_c == '-');
            int64_t w = ((int64_t)add_seg(fs(3)) << 1) | (ow_c == '-');
            g_gfa.arcs.insert(g_gfa.arcs.end(), {v, w, ov, ow, 0});
        } else {  // W
            if (f.size() < 7) continue;
            g_gfa.wsamples += fs(1);
            g_gfa.wsample_off.push_back((int64_t)g_gfa.wsamples.size());
            g_gfa.whap.push_back(is_int_str(f[2], fe[2]) ? atoll(f[2]) : 0);
            g_gfa.wseqnames += fs(3);
            g_gfa.wseqname_off.push_back((int64_t)g_gfa.wseqnames.size());
            g_gfa.wst.push_back(is_int_str(f[4], fe[4]) ? atoll(f[4]) : 0);
            g_gfa.wen.push_back(is_int_str(f[5], fe[5]) ? atoll(f[5]) : 0);
            const char* q = f[6];
            const char* qe = fe[6];
            std::string nm;
            while (q < qe) {
                char ori = *q;
                if (ori != '<' && ori != '>') break;
                const char* r = q + 1;
                while (r < qe && *r != '<' && *r != '>') r++;
                nm.assign(q + 1, r);
                auto it = name2id.find(nm);  // lookup only (gfa-io.cpp:399)
                if (it != name2id.end())
                    g_gfa.wv.push_back(((uint32_t)it->second << 1) |
                                       (ori == '<'));
                q = r;
            }
            g_gfa.wv_off.push_back((int64_t)g_gfa.wv.size());
        }
    }
    finish_fa();
    gzclose(fp);

    int64_t nseg = (int64_t)g_gfa.seg_len.size();
    int64_t nwalk = (int64_t)g_gfa.wv_off.size() - 1;

    // rebuild the sequence blob in segment order
    g_gfa.seqs.clear();
    for (int64_t s = 0; s < nseg; s++) {
        if (g_gfa.has_seq[s] && (size_t)s < seq_by_seg.size())
            g_gfa.seqs += seq_by_seg[s];
        g_gfa.seq_off[s + 1] = (int64_t)g_gfa.seqs.size();
    }
    seq_by_seg.clear();

    // walk flip by majority strand vs first appearance (gfa-io.cpp:64-115)
    {
        std::vector<int8_t> strand(nseg, 0);
        for (int64_t wi = 0; wi < nwalk; wi++) {
            int64_t b = g_gfa.wv_off[wi], e = g_gfa.wv_off[wi + 1];
            for (int64_t t = b; t < e; t++) {
                uint32_t v = g_gfa.wv[t];
                if (strand[v >> 1] == 0) strand[v >> 1] = (v & 1) ? -1 : 1;
            }
        }
        for (int64_t wi = 0; wi < nwalk; wi++) {
            int64_t b = g_gfa.wv_off[wi], e = g_gfa.wv_off[wi + 1];
            int64_t match = 0;
            for (int64_t t = b; t < e; t++) {
                uint32_t v = g_gfa.wv[t];
                int8_t s = (v & 1) ? -1 : 1;
                if (s == strand[v >> 1]) match++;
            }
            if (match >= (e - b) - match) continue;
            std::reverse(g_gfa.wv.begin() + b, g_gfa.wv.begin() + e);
            for (int64_t t = b; t < e; t++) g_gfa.wv[t] ^= 1u;
        }
    }

    // finalize (gfa-base.cpp:421-430 semantics; io/gfa.py:267-338)
    {
        for (int64_t s = 0; s < nseg; s++)
            if (g_gfa.seg_len[s] == 0) g_gfa.seg_del[s] = 1;

        int64_t na = (int64_t)g_gfa.arcs.size() / 5;
        struct Arc {
            int64_t v, w, ov, ow, comp;
        };
        std::vector<Arc> arcs(na);
        for (int64_t i = 0; i < na; i++)
            arcs[i] = {g_gfa.arcs[5 * i], g_gfa.arcs[5 * i + 1],
                       g_gfa.arcs[5 * i + 2], g_gfa.arcs[5 * i + 3],
                       g_gfa.arcs[5 * i + 4]};
        std::stable_sort(arcs.begin(), arcs.end(),
                         [](const Arc& a, const Arc& b) { return a.v < b.v; });

        std::unordered_map<int64_t, std::vector<int64_t>> by_head;
        by_head.reserve(arcs.size() * 2);
        for (int64_t i = 0; i < na; i++) by_head[arcs[i].v].push_back(i);

        std::vector<int8_t> deleted(na, 0);
        // fix_semi_arc (gfa-base.cpp:235-267)
        for (int64_t i = 0; i < na; i++) {
            Arc& a = arcs[i];
            if (deleted[i] ||
                (a.ov != GFA_INT32_MAX && a.ow != GFA_INT32_MAX))
                continue;
            int64_t wcomp = a.w ^ 1;
            int64_t cand = -1, ncand = 0;
            auto it = by_head.find(wcomp);
            if (it != by_head.end()) {
                for (int64_t j : it->second) {
                    if (!deleted[j] && arcs[j].w == (a.v ^ 1)) {
                        cand = j;
                        ncand++;
                    }
                }
            }
            if (ncand == 1) {
                Arc& b = arcs[cand];
                bool is_multi =
                    (a.ov != GFA_INT32_MAX && b.ow != GFA_INT32_MAX &&
                     a.ov != b.ow) ||
                    (a.ow != GFA_INT32_MAX && b.ov != GFA_INT32_MAX &&
                     a.ow != b.ov);
                if (!is_multi) {
                    if (b.ov != GFA_INT32_MAX) a.ow = b.ov;
                    if (b.ow != GFA_INT32_MAX) a.ov = b.ow;
                    continue;
                }
            }
            deleted[i] = 1;
        }
        // fix_symm_add (gfa-base.cpp:269-304)
        std::vector<Arc> extra;
        for (int64_t i = 0; i < na; i++) {
            Arc& a = arcs[i];
            if (deleted[i] || a.comp) continue;
            bool found = false;
            auto it = by_head.find(a.w ^ 1);
            if (it != by_head.end()) {
                for (int64_t j : it->second) {
                    if (deleted[j] || arcs[j].comp) continue;
                    Arc& b = arcs[j];
                    if (b.w == (a.v ^ 1) && b.ov == a.ow && b.ow == a.ov) {
                        b.comp = 1;
                        found = true;
                        break;
                    }
                }
            }
            if (!found) extra.push_back({a.w ^ 1, a.v ^ 1, a.ow, a.ov, 1});
        }
        arcs.insert(arcs.end(), extra.begin(), extra.end());
        deleted.resize(arcs.size(), 0);

        std::vector<Arc> fin;
        fin.reserve(arcs.size());
        for (size_t i = 0; i < arcs.size(); i++) {
            const Arc& a = arcs[i];
            if (deleted[i]) continue;
            if (g_gfa.seg_del[a.v >> 1] || g_gfa.seg_del[a.w >> 1]) continue;
            fin.push_back(a);
        }
        auto keyof = [&](const Arc& a) {
            int64_t ov = a.ov == GFA_INT32_MAX ? 0 : a.ov;
            return std::make_pair(a.v, g_gfa.seg_len[a.v >> 1] - ov);
        };
        std::stable_sort(fin.begin(), fin.end(),
                         [&](const Arc& a, const Arc& b) {
                             return keyof(a) < keyof(b);
                         });
        g_gfa.arcs.clear();
        for (const Arc& a : fin)
            g_gfa.arcs.insert(g_gfa.arcs.end(),
                              {a.v, a.w, a.ov, a.ow, a.comp});
    }
    return nseg;
}

int64_t dg_gfa_names_len() { return (int64_t)g_gfa.names.size(); }
int64_t dg_gfa_seqs_len() { return (int64_t)g_gfa.seqs.size(); }
int64_t dg_gfa_narcs() { return (int64_t)g_gfa.arcs.size() / 5; }
int64_t dg_gfa_nwalks() { return (int64_t)g_gfa.wv_off.size() - 1; }
int64_t dg_gfa_wsamples_len() { return (int64_t)g_gfa.wsamples.size(); }
int64_t dg_gfa_wseqnames_len() { return (int64_t)g_gfa.wseqnames.size(); }
int64_t dg_gfa_wv_len() { return (int64_t)g_gfa.wv.size(); }

void dg_gfa_fetch_segs(uint8_t* names, int64_t* name_off, uint8_t* seqs,
                       int64_t* seq_off, int8_t* has_seq, int64_t* seg_len,
                       int8_t* seg_del) {
    memcpy(names, g_gfa.names.data(), g_gfa.names.size());
    memcpy(name_off, g_gfa.name_off.data(), g_gfa.name_off.size() * 8);
    memcpy(seqs, g_gfa.seqs.data(), g_gfa.seqs.size());
    memcpy(seq_off, g_gfa.seq_off.data(), g_gfa.seq_off.size() * 8);
    memcpy(has_seq, g_gfa.has_seq.data(), g_gfa.has_seq.size());
    memcpy(seg_len, g_gfa.seg_len.data(), g_gfa.seg_len.size() * 8);
    memcpy(seg_del, g_gfa.seg_del.data(), g_gfa.seg_del.size());
}

void dg_gfa_fetch_arcs(int64_t* arcs) {
    memcpy(arcs, g_gfa.arcs.data(), g_gfa.arcs.size() * 8);
}

void dg_gfa_fetch_walks(uint8_t* samples, int64_t* sample_off,
                        uint8_t* seqnames, int64_t* seqname_off,
                        int64_t* hap, int64_t* st, int64_t* en, uint32_t* wv,
                        int64_t* wv_off) {
    memcpy(samples, g_gfa.wsamples.data(), g_gfa.wsamples.size());
    memcpy(sample_off, g_gfa.wsample_off.data(),
           g_gfa.wsample_off.size() * 8);
    memcpy(seqnames, g_gfa.wseqnames.data(), g_gfa.wseqnames.size());
    memcpy(seqname_off, g_gfa.wseqname_off.data(),
           g_gfa.wseqname_off.size() * 8);
    memcpy(hap, g_gfa.whap.data(), g_gfa.whap.size() * 8);
    memcpy(st, g_gfa.wst.data(), g_gfa.wst.size() * 8);
    memcpy(en, g_gfa.wen.data(), g_gfa.wen.size() * 8);
    memcpy(wv, g_gfa.wv.data(), g_gfa.wv.size() * 4);
    memcpy(wv_off, g_gfa.wv_off.data(), g_gfa.wv_off.size() * 8);
    g_gfa = GfaResult();
}

const char* dg_version() { return "dgcore 0.1"; }

// Threads the parallel loops can use: 1 in a build without OpenMP.
int32_t dg_max_threads() {
#ifdef _OPENMP
    return omp_get_num_procs();
#else
    return 1;
#endif
}

}  // extern "C"
