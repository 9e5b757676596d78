"""Fused one-scan device diploid pair DP in plain JAX.

The whole forward pass is ONE `lax.scan` over all L-1 transitions, and
the traceback one more, so a run is a handful of dispatches. The
backpointers of every level stay in device memory for the traceback: at
the MHC_4 shapes that is about 0.85 GB of int16 before bucket padding.

  * state V [R+1, Bmax, Bmax] int32 lives in device memory across the scan; each
    transition updates only its bucket's corner slice (stale values
    outside a corner are never read: a transition reads rows/cols
    < k == previous k2 <= previous corner);
  * per-transition tables are loaded inside the step with
    `dynamic_slice` from per-bucket stacked arrays; `lax.switch` picks
    the bucket branch (fixed small shape for 96% of levels, wider
    shapes for the rest) so padding stays proportionate;
  * the candidate max is a lexicographic (value, tie) compare-and-
    select:  value = V_pred + score,  tie = slot pair (p, q) encoded so
    larger tie == smaller (p, q). Slot order equals predecessor-index
    order (edges are materialized sorted by (dst, src) — see plan), so
    maximizing the tie is exactly the reference tie-break "smaller
    pred_i, then smaller pred_j" (approximator.cpp:655-659). Two int32
    tensors instead of one packed key: packing value<<tie_bits into an
    int32 overflows for P >= 64 (tie_bits >= 12) and needs fragile
    sentinel range analysis; the explicit pair is range-safe for any P
    and any DP value < 2^30. No SH carry, no best_i/j arrays: s_het is
    recomputed during the traceback.
  * backpointers (the tie field) are written as int16 into ONE flat
    device buffer carried through the scan, level l's [R+1, B, B] block
    at offset boff[l]. The switch branch only returns the block, padded
    to the widest bucket's size; the dynamic-update-slice into the
    buffer happens outside the switch, so it stays in place (a buffer
    threaded through `lax.switch` is copied at every level, which makes
    the pass quadratic in the number of levels). The padding tail of a
    level's block is overwritten by the next level's. The backward pass
    is a pure traceback — no forward replay.

The r-shift by edge weight w ∈ {0,1} is folded into the gathers: the
row gather indexes concat([V, shift1(V)], rows) with i_of + B*wu, the
column gather indexes concat([A, shift1(A)], cols) with j_of + B*wv,
matching approximator.cpp:612-651 exactly.

Reference: src/approximator.cpp:362-716 (semantics only; the
formulation here is gather-form, lock-free, and single-dispatch).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

NEG = -(2**19)  # unreachable sentinel; re-pinned each level (sticky)
REACH_T = -(2**18)  # values above this are reachable
INVALID = -(2**30)  # candidate value for padded/absent pred slots


def _ceil_pow2(x: int, lo: int) -> int:
    b = lo
    while b < x:
        b *= 2
    return b


@dataclass(frozen=True)
class Bucket:
    B: int  # padded level width (max(k, k2) <= B)
    P: int  # padded pred slots
    W: int  # colour words
    qbits: int  # tie bits for the q slot (ceil log2 P)

    @property
    def tie_bits(self) -> int:
        return 2 * self.qbits


@dataclass
class FusedPlan:
    R: int
    L1: int  # number of transitions
    buckets: list[Bucket]
    bid: np.ndarray  # [L1] int32 bucket id per transition
    row: np.ndarray  # [L1] int32 row within the bucket stack
    boff: np.ndarray  # [L1] int32 offset of the level's backpointer block
    # per bucket: stacked tables
    pi: list[np.ndarray]  # [N, B, P] int32 pred index (identity pad)
    pw: list[np.ndarray]  # [N, B, P] int8 edge weight
    pm: list[np.ndarray]  # [N, B, P] int8 slot valid
    hm: list[np.ndarray]  # [N, 4, B, W] uint32 (Hl, Tl, Hr, Tr)
    widths: np.ndarray = field(default=None)  # [L] level widths
    max_value_bound: int = 0  # upper bound on any DP value


# bucket ladder: (B, P) pairs tried in order; W from {1, 8, 32}
_B_LADDER = (16, 32, 64, 96, 128, 160, 256, 512, 1024, 2048, 4096)
_P_LADDER = (4, 8, 16, 32, 64, 128)
_W_LADDER = (1, 8, 32, 128)


def plan_fused(
    level_ptr: np.ndarray,
    adj_ptr: np.ndarray,
    adj_v: np.ndarray,
    adj_w: np.ndarray,
    hom_ptr: np.ndarray,
    hom_colors: np.ndarray,
    het_ptr: np.ndarray,
    het_colors: np.ndarray,
    R: int,
) -> FusedPlan:
    """Build the fused program from levelized CSR arrays (host side)."""
    level_ptr = np.asarray(level_ptr, np.int64)
    adj_ptr = np.asarray(adj_ptr, np.int64)
    L = len(level_ptr) - 1
    L1 = L - 1
    widths = np.diff(level_ptr)
    if L1 <= 0:
        raise ValueError("need at least 2 levels")
    if int(widths.max()) > _B_LADDER[-1]:
        raise ValueError(f"level width {int(widths.max())} > {_B_LADDER[-1]}")

    # ---- pass 1: per-transition shape requirements ----
    need = []  # (B, P, W) per transition
    per = []  # cached per-transition raw pieces
    total_score_mass = 0
    max_level_score = 0
    for l in range(L1):
        b0, b1, b2 = int(level_ptr[l]), int(level_ptr[l + 1]), int(level_ptr[l + 2])
        k, k2 = b1 - b0, b2 - b1
        e0, e1 = int(adj_ptr[b0]), int(adj_ptr[b1])
        dsts = adj_v[e0:e1].astype(np.int64) - b1
        ws = adj_w[e0:e1].astype(np.int8)
        srcs = np.repeat(
            np.arange(k, dtype=np.int32),
            np.diff(adj_ptr[b0 : b1 + 1]).astype(np.int64),
        )
        # sort edges by (dst, src): srcs are already increasing per dst
        # after a stable sort on dst, so slot order == pred-index order
        order = np.argsort(dsts, kind="stable")
        dsts_s, srcs_s, ws_s = dsts[order], srcs[order], ws[order]
        indeg = np.bincount(dsts_s, minlength=k2) if k2 else np.zeros(0, np.int64)
        Pl = max(int(indeg.max()) if len(indeg) else 1, 1)

        cs = np.concatenate(
            [
                hom_colors[hom_ptr[b0] : hom_ptr[b2]],
                het_colors[het_ptr[b0] : het_ptr[b2]],
            ]
        )
        uniq = np.unique(cs)
        Wl = max(1, (len(uniq) + 31) // 32)
        total_score_mass += 2 * len(cs)  # loose per-level max-score bound
        max_level_score = max(max_level_score, 2 * len(cs))
        if Pl > _P_LADDER[-1]:
            raise ValueError(
                f"level {l}: in-degree {Pl} > {_P_LADDER[-1]} pred slots"
            )
        if Wl > _W_LADDER[-1]:
            raise ValueError(
                f"level {l}: {len(uniq)} distinct colours need {Wl} words "
                f"> {_W_LADDER[-1]}"
            )
        need.append((max(k, k2), Pl, Wl))
        per.append((k, k2, dsts_s, srcs_s, ws_s, indeg, uniq, b0, b1, b2))

    # ---- choose buckets: distinct quantized shapes actually present ----
    def quant(v, ladder):
        for x in ladder:
            if v <= x:
                return x
        return ladder[-1]

    from collections import Counter

    qcount = Counter(
        (quant(B, _B_LADDER), quant(P, _P_LADDER), quant(W, _W_LADDER))
        for (B, P, W) in need
    )
    # merge sparse shapes upward: every branch is a separately compiled
    # program inside lax.switch, so keep the bucket count small — a shape
    # with few levels is cheaper run padded than compiled separately
    MIN_LEVELS = max(64, L1 // 1000)
    shapes = sorted(qcount)
    merged: dict[tuple, int] = {}
    kept = [s for s in shapes if qcount[s] >= MIN_LEVELS]
    if not kept:
        kept = [max(shapes)]
    catch_all = (
        max(s[0] for s in shapes),
        max(s[1] for s in shapes),
        max(s[2] for s in shapes),
    )
    for s in shapes:
        if qcount[s] >= MIN_LEVELS:
            merged[s] = None
            continue
        doms = [
            t
            for t in kept
            if t[0] >= s[0] and t[1] >= s[1] and t[2] >= s[2]
        ]
        if doms:
            # cheapest dominating kept shape by padded compute
            merged[s] = min(doms, key=lambda t: t[0] * t[0] * t[1] * t[1] * t[2])
        else:
            merged[s] = catch_all
    if any(v == catch_all for v in merged.values()) and catch_all not in kept:
        kept.append(catch_all)
    qshapes = sorted(set(kept))

    def to_bucket_shape(B, P, W):
        s = (quant(B, _B_LADDER), quant(P, _P_LADDER), quant(W, _W_LADDER))
        m = merged.get(s)
        return s if m is None else m
    buckets = [
        Bucket(B, P, W, max(int(np.ceil(np.log2(P))), 1)) for (B, P, W) in qshapes
    ]
    bindex = {qs: i for i, qs in enumerate(qshapes)}

    # range guards for the lexicographic max (see _branch_step):
    #  * unreachable stickiness: a NEG-valued pred plus one level's score
    #    must stay below REACH_T so re-pinning keeps it at NEG;
    #  * value overflow: DP values only ever grow by score, so the total
    #    score mass bounds every candidate value; INVALID = -2^30 must
    #    stay strictly below NEG + 0 and cand + score must fit int32.
    if max_level_score > REACH_T - NEG:  # need NEG + score <= REACH_T
        raise ValueError(
            f"per-level score mass {max_level_score} exceeds the "
            f"unreachable-sentinel margin {REACH_T - NEG}"
        )
    if total_score_mass >= (1 << 30):
        raise ValueError(
            f"total score mass {total_score_mass} >= 2^30 would overflow "
            "int32 DP values"
        )

    bid = np.zeros(L1, np.int32)
    row = np.zeros(L1, np.int32)
    counts = [0] * len(buckets)
    for l, (B, P, W) in enumerate(need):
        i = bindex[to_bucket_shape(B, P, W)]
        bid[l] = i
        row[l] = counts[i]
        counts[i] += 1

    # the backpointer buffer is a flat int16 array indexed with int32
    # offsets (dynamic_update_slice) — it must stay below 2^31 elements
    block = np.array([(R + 1) * b.B * b.B for b in buckets], np.int64)[bid]
    boff = np.concatenate([[0], np.cumsum(block)[:-1]])
    nelem = int(block.sum()) + int(block.max())
    if nelem >= (1 << 31):
        raise ValueError(
            f"backpointer buffer of {nelem} elements >= 2^31: int32 "
            "offsets would overflow"
        )

    # ---- pass 2: fill stacked tables ----
    pi = [np.zeros((n, b.B, b.P), np.int32) for n, b in zip(counts, buckets)]
    pw = [np.zeros((n, b.B, b.P), np.int8) for n, b in zip(counts, buckets)]
    pm = [np.zeros((n, b.B, b.P), np.int8) for n, b in zip(counts, buckets)]
    hm = [np.zeros((n, 4, b.B, b.W), np.uint32) for n, b in zip(counts, buckets)]
    for l in range(L1):
        k, k2, dsts_s, srcs_s, ws_s, indeg, uniq, b0, b1, b2 = per[l]
        i, r = int(bid[l]), int(row[l])
        if len(dsts_s):
            slot = np.concatenate([np.arange(c) for c in indeg])
            pi[i][r][dsts_s, slot] = srcs_s
            pw[i][r][dsts_s, slot] = ws_s
            pm[i][r][dsts_s, slot] = 1

        Wb = buckets[i].W

        def put(dst_plane, vs, ve, ptr, colors):
            seg = colors[int(ptr[vs]) : int(ptr[ve])]
            if len(seg):
                loc = np.searchsorted(uniq, seg).astype(np.int64)
                rows = np.repeat(
                    np.arange(ve - vs, dtype=np.int64),
                    np.diff(ptr[vs : ve + 1]).astype(np.int64),
                )
                np.bitwise_or.at(
                    hm[i][r, dst_plane],
                    (rows, loc // 32),
                    np.uint32(1) << (loc % 32).astype(np.uint32),
                )

        put(0, b0, b1, hom_ptr, hom_colors)  # Hl
        put(1, b0, b1, het_ptr, het_colors)  # Tl
        put(2, b1, b2, hom_ptr, hom_colors)  # Hr
        put(3, b1, b2, het_ptr, het_colors)  # Tr

    return FusedPlan(
        R=R, L1=L1, buckets=buckets, bid=bid, row=row,
        boff=boff.astype(np.int32),
        pi=pi, pw=pw, pm=pm, hm=hm, widths=widths,
        max_value_bound=total_score_mass,
    )


# ------------------------------------------------------------------
# device program
# ------------------------------------------------------------------


def _branch_step(R: int, bk: Bucket, Bmax: int):
    """Returns f(V_pad, row, stacks_i) -> (V_pad, backpointer block) for
    one bucket; the block is flat int16, zero-padded to the widest
    bucket's (R+1)·Bmax² elements."""
    import jax
    import jax.numpy as jnp

    B, P, W = bk.B, bk.P, bk.W
    qb = bk.qbits

    def pcs(x):
        return jax.lax.population_count(x).sum(-1).astype(jnp.int32)

    def f(V_pad, row, PI, PW, PM, HM):
        pi = jax.lax.dynamic_slice_in_dim(PI, row, 1, 0)[0]
        pwt = jax.lax.dynamic_slice_in_dim(PW, row, 1, 0)[0].astype(jnp.int32)
        pmt = jax.lax.dynamic_slice_in_dim(PM, row, 1, 0)[0]
        hmt = jax.lax.dynamic_slice_in_dim(HM, row, 1, 0)[0]
        Hl, Tl, Hr, Tr = hmt[0], hmt[1], hmt[2], hmt[3]

        V = jax.lax.slice(V_pad, (0, 0, 0), (R + 1, B, B))
        negrow = jnp.full((1, B, B), NEG, jnp.int32)
        Vs1 = jnp.concatenate([negrow, V[:R]], axis=0)
        Vcat = jnp.concatenate([V, Vs1], axis=1)  # rows: s1 + B*wu

        HRu = Hr[:, None, :] | Hr[None, :, :]
        TRu = Tr[:, None, :] | Tr[None, :, :]

        # lexicographic (value, tie) running max; see module docstring
        best_v = jnp.full((R + 1, B, B), jnp.int32(INVALID), jnp.int32)
        best_t = jnp.zeros((R + 1, B, B), jnp.int32)

        def upd(best, cand, tie):
            best_v, best_t = best
            take = (cand > best_v) | ((cand == best_v) & (tie > best_t))
            return (
                jnp.where(take, cand, best_v),
                jnp.where(take, tie, best_t),
            )

        def pair_cand(best, ip, wp, mp, iq, wq, mq, tie):
            """p-side on rows, q-side on cols; tie is an int32 scalar."""
            A = Vcat[:, ip + B * wp, :]
            As1 = jnp.concatenate([negrow, A[:R]], axis=0)
            Acat = jnp.concatenate([A, As1], axis=2)  # cols: s2 + B*wv
            Vg = Acat[:, :, iq + B * wq]
            HLu = Hl[ip][:, None, :] | Hl[iq][None, :, :]
            TLu = Tl[ip][:, None, :] | Tl[iq][None, :, :]
            score = pcs(HLu & HRu) + pcs(TLu ^ TRu)
            valid = (mp[:, None] & mq[None, :]) != 0
            cand = jnp.where(
                valid[None], Vg + score[None], jnp.int32(INVALID)
            )
            return upd(best, cand, tie)

        if P <= 4:
            # unrolled; the row gather+shift per p is shared across q
            for p in range(P):
                A = Vcat[:, pi[:, p] + B * pwt[:, p], :]
                As1 = jnp.concatenate([negrow, A[:R]], axis=0)
                Acat = jnp.concatenate([A, As1], axis=2)
                Hlp, Tlp = Hl[pi[:, p]], Tl[pi[:, p]]
                for q in range(P):
                    Vg = Acat[:, :, pi[:, q] + B * pwt[:, q]]
                    HLu = Hlp[:, None, :] | Hl[pi[:, q]][None, :, :]
                    TLu = Tlp[:, None, :] | Tl[pi[:, q]][None, :, :]
                    score = pcs(HLu & HRu) + pcs(TLu ^ TRu)
                    tie = jnp.int32(((P - 1 - p) << qb) | (P - 1 - q))
                    valid = (pmt[:, p][:, None] & pmt[:, q][None, :]) != 0
                    cand = jnp.where(
                        valid[None], Vg + score[None], jnp.int32(INVALID)
                    )
                    best_v, best_t = upd((best_v, best_t), cand, tie)
        else:
            # traced loop over slot pairs keeps the program small
            def body(pq, best):
                p = pq // P
                q = pq % P

                def col(a, j):
                    return jax.lax.dynamic_index_in_dim(
                        a, j, axis=1, keepdims=False
                    )

                tie = ((jnp.int32(P - 1) - p) << qb) | (jnp.int32(P - 1) - q)
                return pair_cand(
                    best,
                    col(pi, p), col(pwt, p), col(pmt, p),
                    col(pi, q), col(pwt, q), col(pmt, q), tie,
                )

            best_v, best_t = jax.lax.fori_loop(
                0, P * P, body, (best_v, best_t)
            )

        Vn = jnp.where(best_v > jnp.int32(REACH_T), best_v, jnp.int32(NEG))
        bp = best_t.astype(jnp.int16)

        # stale state outside the corner is never read (see module doc)
        V_out = jax.lax.dynamic_update_slice(V_pad, Vn, (0, 0, 0))
        pad = (R + 1) * (Bmax * Bmax - B * B)
        block = bp.reshape(-1)
        if pad:
            block = jnp.concatenate([block, jnp.zeros(pad, jnp.int16)])
        return V_out, block

    return f


class FusedDiploidDP:
    """Single-dispatch forward + single-dispatch traceback.

    Same output contract as the chunked DeviceDiploidDP:
    run() -> (sink_value, sink_s_het, transitions) with transitions a
    list of (level, pi, pj, i2, j2, wu, wv) for level L-1 .. 1.
    """

    def __init__(self, plan: FusedPlan):
        self.plan = plan
        self.R = plan.R
        self.Bmax = max(b.B for b in plan.buckets)
        self._device = None
        self._jit = {}

    # ---------------- staging ----------------
    def _ship(self):
        import jax

        if self._device is not None:
            return self._device
        p = self.plan
        stacks = []
        for i in range(len(p.buckets)):
            stacks.append(
                tuple(
                    jax.device_put(a)
                    for a in (p.pi[i], p.pw[i], p.pm[i], p.hm[i])
                )
            )
        xs = (
            jax.device_put(p.bid),
            jax.device_put(p.row),
            jax.device_put(p.boff),
        )
        self._device = (tuple(stacks), xs)
        return self._device

    def _buf_size(self) -> int:
        """Backpointer buffer elements: every level's block, plus the
        padding tail of the last one."""
        return int(self.plan.boff[-1]) + (self.R + 1) * self.Bmax ** 2

    def _forward_fn(self):
        import jax
        import jax.numpy as jnp

        key = "fwd"
        if key in self._jit:
            return self._jit[key]
        p = self.plan
        R, Bmax = self.R, self.Bmax
        branch_fns = [_branch_step(R, b, Bmax) for b in p.buckets]

        def run(stacks, xs, V0, buf):
            def body(carry, x):
                V, buf = carry
                b, r, off = x

                def mk(i):
                    def g(op):
                        V, r = op
                        return branch_fns[i](V, r, *stacks[i])

                    return g

                V2, block = jax.lax.switch(
                    b, [mk(i) for i in range(len(p.buckets))], (V, r)
                )
                buf = jax.lax.dynamic_update_slice(buf, block, (off,))
                return (V2, buf), None

            (Vf, buff), _ = jax.lax.scan(body, (V0, buf), xs)
            return Vf, buff

        self._jit[key] = jax.jit(run, donate_argnums=(3,))
        return self._jit[key]

    def _initial(self):
        import jax
        import jax.numpy as jnp

        R, Bmax = self.R, self.Bmax
        V0 = np.full((R + 1, Bmax, Bmax), NEG, np.int32)
        V0[:, 0, 0] = 0
        return jax.device_put(V0), jnp.zeros(self._buf_size(), jnp.int16)

    # ---------------- staging ----------------
    def ship(self):
        """Copy the stacked tables to the device and wait for them."""
        import jax

        jax.block_until_ready(self._ship())

    def compile(self):
        """Compile the forward, traceback and finalize executables."""
        import jax
        import jax.numpy as jnp

        stacks, xs = self._ship()
        R, Bmax, L1 = self.R, self.Bmax, self.plan.L1
        V = jax.ShapeDtypeStruct((R + 1, Bmax, Bmax), jnp.int32)
        bufs = jax.ShapeDtypeStruct((self._buf_size(),), jnp.int16)
        sh = jax.ShapeDtypeStruct((), jnp.int32)
        rows = jax.ShapeDtypeStruct((L1, 4), jnp.int32)
        for key, fn, args in (
            ("fwd", self._forward_fn(), (stacks, xs, V, bufs)),
            ("trace", self._trace_fn(), (stacks, bufs, xs)),
            ("finalize", self._finalize_fn(), (V, sh, rows)),
        ):
            self._jit[key] = fn.lower(*args).compile()

    def measure_passes(self, passes: int = 1):
        """Forward-pass walls after one warm-up pass; each pass is ended
        by a device-to-host fetch of the sink value.

        Returns ([wall_0..wall_{n-1}], sink_value)."""
        import time as _time

        stacks, xs = self._ship()
        fwd = self._forward_fn()

        def one():
            V0, bufs = self._initial()
            t0 = _time.perf_counter()
            Vf, bufs = fwd(stacks, xs, V0, bufs)
            v = int(np.asarray(Vf[self.R, 0, 0]))
            return _time.perf_counter() - t0, v

        one()
        walls, v = [], None
        for _ in range(max(passes, 1)):
            w, v = one()
            walls.append(w)
        return walls, v

    # ---------------- traceback ----------------
    def _trace_fn(self):
        import jax
        import jax.numpy as jnp

        key = "trace"
        if key in self._jit:
            return self._jit[key]
        p = self.plan
        R = self.R
        nb = len(p.buckets)

        def run(stacks, buf, xs):
            # xs (reversed order): bid, row, boff
            widths = jnp.asarray([bk.B for bk in p.buckets], jnp.int32)

            def body(carry, x):
                i2, j2, r2, sh = carry
                b, r, off = x
                # read outside the switch: a buffer operand of a switch
                # branch may be copied at every level
                B = widths[b]
                bp = jax.lax.dynamic_slice(
                    buf, (off + (r2 * B + i2) * B + j2,), (1,))[0]

                def mk(i):
                    bk = p.buckets[i]
                    B, P, W, qb = bk.B, bk.P, bk.W, bk.qbits

                    def g(op):
                        i2, j2, r_row, bp = op
                        bp = bp.astype(jnp.int32) & jnp.int32((1 << (2 * qb)) - 1)
                        ps = jnp.int32(P - 1) - (bp >> qb)
                        qs = jnp.int32(P - 1) - (bp & ((1 << qb) - 1))
                        PI, PW, PM, HM = stacks[i]
                        pirow = jax.lax.dynamic_slice(
                            PI, (r_row, i2, ps), (1, 1, 1)
                        )[0, 0, 0]
                        pjrow = jax.lax.dynamic_slice(
                            PI, (r_row, j2, qs), (1, 1, 1)
                        )[0, 0, 0]
                        wu = jax.lax.dynamic_slice(
                            PW, (r_row, i2, ps), (1, 1, 1)
                        )[0, 0, 0].astype(jnp.int32)
                        wv = jax.lax.dynamic_slice(
                            PW, (r_row, j2, qs), (1, 1, 1)
                        )[0, 0, 0].astype(jnp.int32)
                        # s_het increment: popcount(TLu ^ TRu) of the chosen pair
                        TlA = jax.lax.dynamic_slice(
                            HM, (r_row, 1, pirow, 0), (1, 1, 1, W)
                        )[0, 0, 0]
                        TlB = jax.lax.dynamic_slice(
                            HM, (r_row, 1, pjrow, 0), (1, 1, 1, W)
                        )[0, 0, 0]
                        TrA = jax.lax.dynamic_slice(
                            HM, (r_row, 3, i2, 0), (1, 1, 1, W)
                        )[0, 0, 0]
                        TrB = jax.lax.dynamic_slice(
                            HM, (r_row, 3, j2, 0), (1, 1, 1, W)
                        )[0, 0, 0]
                        symd = (
                            jax.lax.population_count((TlA | TlB) ^ (TrA | TrB))
                            .sum()
                            .astype(jnp.int32)
                        )
                        return pirow, pjrow, wu, wv, symd

                    return g

                pi_, pj_, wu, wv, symd = jax.lax.switch(
                    b, [mk(i) for i in range(nb)], (i2, j2, r, bp)
                )
                rows = jnp.stack([pi_, pj_, wu, wv])
                return (pi_, pj_, r2 - wu - wv, sh + symd), rows

            carry0 = (jnp.int32(0), jnp.int32(0), jnp.int32(R), jnp.int32(0))
            (fi, fj, fr, sh), rows = jax.lax.scan(body, carry0, xs)
            return sh, rows

        self._jit[key] = jax.jit(run)
        return self._jit[key]

    def _finalize_fn(self):
        import jax
        import jax.numpy as jnp

        key = "finalize"
        if key in self._jit:
            return self._jit[key]

        R = self.R

        def f(V, sh, rows):
            head = jnp.stack([V[R, 0, 0], sh])
            return jnp.concatenate([head, rows.reshape(-1)])

        self._jit[key] = jax.jit(f)
        return self._jit[key]

    # ---------------- driver ----------------
    def run(self, verbose: bool = False):
        import sys
        import time as _time

        import jax
        import jax.numpy as jnp

        t0 = _time.time()

        def vlog(msg):
            if verbose:
                print(f"[fuseddp {_time.time()-t0:6.1f}s] {msg}",
                      file=sys.stderr, flush=True)

        p = self.plan
        stacks, xs = self._ship()
        vlog(f"stacks shipped ({len(p.buckets)} buckets, L1={p.L1})")
        V0, bufs = self._initial()
        Vf, bufs = self._forward_fn()(stacks, xs, V0, bufs)
        vlog("forward enqueued")
        xs_rev = tuple(jnp.flip(a, 0) for a in xs)
        sh, rows = self._trace_fn()(stacks, bufs, xs_rev)
        out = np.asarray(self._finalize_fn()(Vf, sh, rows))
        vlog("fetched")
        sink_val = int(out[0])
        sink_shet = int(out[1])
        path = out[2:].reshape(-1, 4)  # reversed order: level L1..1

        transitions = []
        i2, j2 = 0, 0
        for t in range(p.L1):
            l = p.L1 - t
            pi_, pj_, wu, wv = (int(v) for v in path[t])
            transitions.append((l, pi_, pj_, i2, j2, wu, wv))
            i2, j2 = pi_, pj_
        transitions.reverse()
        return sink_val, sink_shet, transitions
