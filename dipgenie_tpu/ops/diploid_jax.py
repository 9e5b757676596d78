"""Chunked device diploid pair DP: level-synchronous wavefront in plain JAX.

The hot loop of the pipeline (reference: src/approximator.cpp:362-716)
recast for XLA:

  * state V[(R+1), B, B] int32 (+ s_het companion) per level, padded to a
    fixed bucket width B;
  * per-transition inputs: predecessor tables (pred index + edge weight,
    padded to P slots) and per-vertex HOM/HET colour bitsets re-indexed
    to the level-pair's local colour universe (W uint32 words) — scoring
    is popcount((h1|h2)&(h3|h4)) + popcount((t1|t2)^(t3|t4)), exactly the
    reference's 4-way merge counts (approximator.cpp:269-311);
  * the deterministic tie-break (value, then smaller pred_i, then smaller
    pred_j — approximator.cpp:655-659) is encoded in the masked reduction,
    so results match the exact/native tiers bit for bit;
  * transitions that fit the uniform small bucket (the vast majority) run
    inside `lax.scan` chunks of a few fixed lengths over a device-resident
    pre-stacked transition array; variable-length runs are padded with
    no-op identity transitions so only a handful of shapes compile.
    Oversized transitions dispatch to per-shape jitted "big" steps over
    per-shape device stacks.

All inputs are shipped to device memory once and every step is an
asynchronous dispatch. The forward pass stores periodic state checkpoints
on device; backtracking replays each span with backpointers and walks
them with a reverse `lax.scan`, also on device. One host transfer at the
end fetches (value, s_het, path).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NEG_INF = -(2**28)
VALID_T = -(2**27)  # values above this are reachable states

SMALL_B = 32
SMALL_P = 4
SMALL_W = 1
CHUNKS = (64, 512)


@dataclass
class Transition:
    k: int
    k2: int
    pred_i: np.ndarray  # [k2, P] int32
    pred_w: np.ndarray  # [k2, P] int32
    pred_m: np.ndarray  # [k2, P] bool
    Hl: np.ndarray  # [k, W] uint32
    Tl: np.ndarray
    Hr: np.ndarray  # [k2, W] uint32
    Tr: np.ndarray


def _bucket(x: int, opts) -> int:
    """Smallest rung >= x; past the last rung, keep doubling it."""
    for o in opts:
        if x <= o:
            return o
    o = opts[-1]
    while o < x:
        o *= 2
    return o


def plan_transitions(
    level_ptr: np.ndarray,
    adj_ptr: np.ndarray,
    adj_v: np.ndarray,
    adj_w: np.ndarray,
    hom_ptr: np.ndarray,
    hom_colors: np.ndarray,
    het_ptr: np.ndarray,
    het_colors: np.ndarray,
) -> list[Transition]:
    """Build per-transition tables from levelized CSR arrays (host)."""
    L = len(level_ptr) - 1
    widths = np.diff(np.asarray(level_ptr, np.int64))
    if len(widths) and int(widths.max()) >= 4096:
        raise ValueError(
            f"level width {int(widths.max())} >= 4096: backpointer packing "
            "(pi | pj<<12) requires every level width < 4096"
        )
    out: list[Transition] = []
    for l in range(L - 1):
        b0, b1, b2 = int(level_ptr[l]), int(level_ptr[l + 1]), int(level_ptr[l + 2])
        k, k2 = b1 - b0, b2 - b1
        e0, e1 = int(adj_ptr[b0]), int(adj_ptr[b1])
        dsts = adj_v[e0:e1] - b1
        ws = adj_w[e0:e1].astype(np.int32)
        srcs = np.repeat(
            np.arange(k, dtype=np.int32),
            np.diff(adj_ptr[b0 : b1 + 1]).astype(np.int64),
        )
        order = np.argsort(dsts, kind="stable")
        dsts_s, srcs_s, ws_s = dsts[order], srcs[order], ws[order]
        indeg = np.bincount(dsts_s, minlength=k2) if k2 else np.zeros(0, np.int64)
        P = max(int(indeg.max()) if len(indeg) else 1, 1)
        pred_i = np.zeros((k2, P), np.int32)
        pred_w = np.zeros((k2, P), np.int32)
        pred_m = np.zeros((k2, P), bool)
        slot = (
            np.concatenate([np.arange(c) for c in indeg])
            if len(dsts_s)
            else np.empty(0, np.int64)
        )
        pred_i[dsts_s, slot] = srcs_s
        pred_w[dsts_s, slot] = ws_s
        pred_m[dsts_s, slot] = True

        cs = np.concatenate(
            [
                hom_colors[hom_ptr[b0] : hom_ptr[b2]],
                het_colors[het_ptr[b0] : het_ptr[b2]],
            ]
        )
        uniq = np.unique(cs)
        W = max(1, (len(uniq) + 31) // 32)

        def masks_fast(vs, ve, ptr, colors):
            cnt = ve - vs
            m = np.zeros((cnt, W), np.uint32)
            seg = colors[ptr[vs] : ptr[ve]]
            if len(seg):
                loc = np.searchsorted(uniq, seg).astype(np.int64)
                rows = np.repeat(
                    np.arange(cnt, dtype=np.int64),
                    np.diff(ptr[vs : ve + 1]).astype(np.int64),
                )
                np.bitwise_or.at(
                    m, (rows, loc // 32), np.uint32(1) << (loc % 32).astype(np.uint32)
                )
            return m

        out.append(
            Transition(
                k, k2, pred_i, pred_w, pred_m,
                masks_fast(b0, b1, hom_ptr, hom_colors),
                masks_fast(b0, b1, het_ptr, het_colors),
                masks_fast(b1, b2, hom_ptr, hom_colors),
                masks_fast(b1, b2, het_ptr, het_colors),
            )
        )
    return out


def _pad_fields(t: Transition, B: int, P: int, W: int):
    pi = np.tile(np.arange(B, dtype=np.int32)[:, None], (1, P))
    pw = np.zeros((B, P), np.int32)
    pm = np.zeros((B, P), bool)
    pi[: t.k2, : t.pred_i.shape[1]] = t.pred_i
    pw[: t.k2, : t.pred_w.shape[1]] = t.pred_w
    pm[: t.k2, : t.pred_m.shape[1]] = t.pred_m
    # rows >= k2 keep identity pred with mask False (stay NEG_INF)

    def padm(m, rows):
        o = np.zeros((B, W), np.uint32)
        o[:rows, : m.shape[1]] = m
        return o

    return (
        pi, pw, pm,
        padm(t.Hl, t.k), padm(t.Tl, t.k), padm(t.Hr, t.k2), padm(t.Tr, t.k2),
    )


def _noop_fields(B: int, P: int, W: int):
    pi = np.tile(np.arange(B, dtype=np.int32)[:, None], (1, P))
    pw = np.zeros((B, P), np.int32)
    pm = np.zeros((B, P), bool)
    pm[:, 0] = True
    z = np.zeros((B, W), np.uint32)
    return pi, pw, pm, z, z, z, z


def _step_body(R: int, P: int, carry, xs):
    """One DP transition. carry = (V, SH) → ((V', SH'), packed bp)."""
    import jax
    import jax.numpy as jnp

    V, SH = carry
    pi, pw, pm, Hl, Tl, Hr, Tr = xs
    B = V.shape[1]
    SENT = np.int32(2**20)

    HRu = Hr[:, None, :] | Hr[None, :, :]
    TRu = Tr[:, None, :] | Tr[None, :, :]

    best_v = jnp.full((R + 1, B, B), NEG_INF, jnp.int32)
    best_i = jnp.full((R + 1, B, B), SENT, jnp.int32)
    best_j = jnp.full((R + 1, B, B), SENT, jnp.int32)
    best_sh = jnp.zeros((R + 1, B, B), jnp.int32)
    best_bp = jnp.zeros((R + 1, B, B), jnp.int32)

    def shift(x, w, fill):
        if w == 0:
            return x
        pad = jnp.full((w,) + x.shape[1:], fill, x.dtype)
        return jnp.concatenate([pad, x[: R + 1 - w]], axis=0)

    Vsh = [shift(V, w, NEG_INF) for w in range(3)]
    SHsh = [shift(SH, w, 0) for w in range(3)]

    def apply_candidate(best, i_of, wu, mu, j_of, wv, mv):
        best_v, best_i, best_j, best_sh, best_bp = best
        m = mu[:, None] & mv[None, :]
        Hli = Hl[i_of]
        Tli = Tl[i_of]
        HLu = Hli[:, None, :] | Hl[j_of][None, :, :]
        TLu = Tli[:, None, :] | Tl[j_of][None, :, :]
        symd = jax.lax.population_count(TLu ^ TRu).sum(-1).astype(jnp.int32)
        score = (
            jax.lax.population_count(HLu & HRu).sum(-1).astype(jnp.int32) + symd
        )

        w = (wu[:, None] + wv[None, :])[None]

        def gsel(stack):
            g0 = stack[0][:, i_of, :][:, :, j_of]
            g1 = stack[1][:, i_of, :][:, :, j_of]
            g2 = stack[2][:, i_of, :][:, :, j_of]
            return jnp.where(w == 0, g0, jnp.where(w == 1, g1, g2))

        Vg = gsel(Vsh)
        SHg = gsel(SHsh)
        cand = Vg + score[None]
        ci = jnp.broadcast_to(i_of[:, None], (B, B))[None]
        cj = jnp.broadcast_to(j_of[None, :], (B, B))[None]
        valid = m[None] & (Vg > VALID_T)
        better = valid & (
            (cand > best_v)
            | (
                (cand == best_v)
                & ((ci < best_i) | ((ci == best_i) & (cj < best_j)))
            )
        )
        bp = ci | (cj << 12) | (wu[:, None][None] << 24) | (wv[None, :][None] << 25)
        return (
            jnp.where(better, cand, best_v),
            jnp.where(better, ci, best_i),
            jnp.where(better, cj, best_j),
            jnp.where(better, SHg + symd, best_sh),
            jnp.where(better, jnp.broadcast_to(bp, best_bp.shape), best_bp),
        )

    best = (best_v, best_i, best_j, best_sh, best_bp)
    if P <= 4:
        # unrolled candidate pairs (compact jaxpr, fully fused)
        for p in range(P):
            for q in range(P):
                best = apply_candidate(
                    best, pi[:, p], pw[:, p], pm[:, p],
                    pi[:, q], pw[:, q], pm[:, q],
                )
    else:
        # large in-degree buckets: traced loop keeps the program small
        def body(pq, best):
            p = pq // P
            q = pq % P
            i_of = jax.lax.dynamic_index_in_dim(pi, p, axis=1, keepdims=False)
            wu = jax.lax.dynamic_index_in_dim(pw, p, axis=1, keepdims=False)
            mu = jax.lax.dynamic_index_in_dim(pm, p, axis=1, keepdims=False)
            j_of = jax.lax.dynamic_index_in_dim(pi, q, axis=1, keepdims=False)
            wv = jax.lax.dynamic_index_in_dim(pw, q, axis=1, keepdims=False)
            mv = jax.lax.dynamic_index_in_dim(pm, q, axis=1, keepdims=False)
            return apply_candidate(best, i_of, wu, mu, j_of, wv, mv)

        best = jax.lax.fori_loop(0, P * P, body, best)
    best_v, best_i, best_j, best_sh, best_bp = best
    return (best_v, best_sh), best_bp


@dataclass
class _Op:
    kind: str  # "scan" | "big"
    T: int  # chunk length (scans) or 1
    start: int  # row offset into the corresponding stack
    shape: tuple  # (B, P, W)
    rows: list  # global transition index per row (-1 = no-op pad)


class DeviceDiploidDP:
    """Latency-tolerant device DP runner; single host sync at the end."""

    def __init__(self, transitions: list[Transition], R: int,
                 small=(SMALL_B, SMALL_P, SMALL_W), chunks=CHUNKS,
                 ckpt_every: int = 24,
                 b_buckets=(64, 160, 512), p_buckets=(8, 32),
                 w_buckets=(8, 32), mesh=None):
        self.R = R
        self.small = small
        self.chunks = sorted(chunks)
        self.ckpt_every = ckpt_every
        self.transitions = transitions
        self.b_buckets = b_buckets
        self.p_buckets = p_buckets
        self.w_buckets = w_buckets
        self.throttle = 1000  # forward ops between queue-depth syncs
        self.throttle_spans = 8  # backward spans between queue-depth syncs
        # optional jax.sharding.Mesh with a "tp" axis: the [(R+1), B, B]
        # state is sharded over its destination-row axis (pair-tile
        # parallelism, SURVEY §7.6); transition stacks are replicated and
        # XLA inserts the all-gathers for the source-row reads
        self.mesh = mesh
        self._jit = {}
        self._build_program()
        self._device_stacks = None

    # ---------------- sharding helpers ----------------
    def _state_sharding(self):
        if self.mesh is None:
            return None
        from jax.sharding import NamedSharding, PartitionSpec as P

        return NamedSharding(self.mesh, P(None, "tp", None))

    def _rep_sharding(self):
        if self.mesh is None:
            return None
        from jax.sharding import NamedSharding, PartitionSpec as P

        return NamedSharding(self.mesh, P())

    def _ys_sharding(self):
        if self.mesh is None:
            return None
        from jax.sharding import NamedSharding, PartitionSpec as P

        return NamedSharding(self.mesh, P(None, None, "tp", None))

    def _jit_sharded(self, fn, out_shardings, **kw):
        """jit with pinned output shardings; input shardings propagate from
        the committed (device_put) stacks and state arrays."""
        import jax

        if self.mesh is None:
            return jax.jit(fn, **kw)
        return jax.jit(fn, out_shardings=out_shardings, **kw)

    # ---------------- program construction (host) ----------------
    def _is_small(self, t: Transition) -> bool:
        B, P, W = self.small
        return (
            max(t.k, t.k2) <= B and t.pred_i.shape[1] <= P and t.Hl.shape[1] <= W
        )

    def _big_shape(self, t: Transition) -> tuple:
        return (
            _bucket(max(t.k, t.k2), self.b_buckets),
            _bucket(t.pred_i.shape[1], self.p_buckets),
            _bucket(t.Hl.shape[1], self.w_buckets),
        )

    def _build_program(self):
        ts = self.transitions
        SB, SP, SW = self.small
        ops: list[_Op] = []
        small_rows: list[int] = []  # global transition id per stacked row
        big_rows: dict[tuple, list[int]] = {}
        i = 0
        L1 = len(ts)
        while i < L1:
            if self._is_small(ts[i]):
                j = i
                while j < L1 and self._is_small(ts[j]):
                    j += 1
                pos = i
                while pos < j:
                    take = min(j - pos, self.chunks[-1])
                    T = next(c for c in self.chunks if c >= take)
                    rows = list(range(pos, pos + take)) + [-1] * (T - take)
                    ops.append(
                        _Op("scan", T, len(small_rows), (SB, SP, SW), rows)
                    )
                    small_rows.extend(rows)
                    pos += take
                i = j
            else:
                shape = self._big_shape(ts[i])
                lst = big_rows.setdefault(shape, [])
                ops.append(_Op("big", 1, len(lst), shape, [i]))
                lst.append(i)
                i += 1
        self.ops = ops
        self._small_rows = small_rows
        self._big_rows = big_rows

    def _build_stacks_np(self):
        SB, SP, SW = self.small
        noop = _noop_fields(SB, SP, SW)
        ts = self.transitions

        def stack_for(rows, B, P, W, noop_fields):
            if not rows:  # e.g. every transition routed to a big bucket
                return tuple(
                    np.zeros((0,) + f.shape, f.dtype) for f in noop_fields
                )
            fields = [[] for _ in range(7)]
            for r in rows:
                fs = noop_fields if r < 0 else _pad_fields(ts[r], B, P, W)
                for fi in range(7):
                    fields[fi].append(fs[fi])
            return tuple(np.stack(f) for f in fields)

        small_stack = stack_for(self._small_rows, SB, SP, SW, noop)
        big_stacks = {
            shape: stack_for(rows, *shape, _noop_fields(*shape))
            for shape, rows in self._big_rows.items()
        }
        return small_stack, big_stacks

    def _ship(self):
        import jax

        if self._device_stacks is not None:
            return self._device_stacks
        small_np, big_np = self._build_stacks_np()
        rep = self._rep_sharding()
        small = tuple(jax.device_put(a, rep) for a in small_np)
        big = {
            s: tuple(jax.device_put(a, rep) for a in arrs)
            for s, arrs in big_np.items()
        }
        self._device_stacks = (small, big)
        return self._device_stacks

    def _initial_state(self, B: int):
        import jax
        import numpy as _np

        R = self.R
        V = _np.full((R + 1, B, B), NEG_INF, _np.int32)
        V[:, 0, 0] = 0
        SH = _np.zeros((R + 1, B, B), _np.int32)
        st = self._state_sharding()
        return jax.device_put(V, st), jax.device_put(SH, st)

    # ---------------- jitted building blocks ----------------
    def _scan_fn(self, T: int, with_bp: bool):
        import jax
        import jax.numpy as jnp

        key = ("scan", T, with_bp)
        if key not in self._jit:
            R, P = self.R, self.small[1]

            def run(stack, V, SH, start):
                xs = tuple(
                    jax.lax.dynamic_slice_in_dim(s, start, T, axis=0)
                    for s in stack
                )

                def f(c, x):
                    (v, sh), bp = _step_body(R, P, c, x)
                    return (v, sh), (bp if with_bp else jnp.int32(0))

                (V2, SH2), ys = jax.lax.scan(f, (V, SH), xs)
                return V2, SH2, ys

            st = self._state_sharding()
            ys_s = self._ys_sharding() if with_bp else self._rep_sharding()
            self._jit[key] = self._jit_sharded(run, (st, st, ys_s))
        return self._jit[key]

    def _big_fn(self, shape):
        import jax

        key = ("big", shape)
        if key not in self._jit:
            R = self.R
            _B, P, _W = shape

            def run(stack, V, SH, idx):
                xs = tuple(
                    jax.lax.dynamic_slice_in_dim(s, idx, 1, axis=0)[0]
                    for s in stack
                )
                (V2, SH2), bp = _step_body(R, P, (V, SH), xs)
                return V2, SH2, bp

            st = self._state_sharding()
            self._jit[key] = self._jit_sharded(run, (st, st, st))
        return self._jit[key]

    def _resize_fn(self, b_from: int, b_to: int):
        import jax
        import jax.numpy as jnp

        key = ("resize", b_from, b_to)
        if key not in self._jit:
            R = self.R

            def run(V, SH):
                if b_to > b_from:
                    Vn = jnp.full((R + 1, b_to, b_to), NEG_INF, jnp.int32)
                    Vn = Vn.at[:, :b_from, :b_from].set(V)
                    Sn = jnp.zeros((R + 1, b_to, b_to), jnp.int32)
                    Sn = Sn.at[:, :b_from, :b_from].set(SH)
                    return Vn, Sn
                return V[:, :b_to, :b_to], SH[:, :b_to, :b_to]

            st = self._state_sharding()
            self._jit[key] = self._jit_sharded(run, (st, st))
        return self._jit[key]

    def _finalize_fn(self):
        """Pack (sink value, sink s_het, path rows) into one array, so the
        host needs one device-to-host transfer."""
        import jax
        import jax.numpy as jnp

        key = "finalize"
        if key not in self._jit:
            R = self.R

            def f(V, SH, pb):
                head = jnp.stack([V[R, 0, 0], SH[R, 0, 0]])
                return jnp.concatenate([head, pb.reshape(-1)])

            self._jit[key] = self._jit_sharded(f, self._rep_sharding())
        return self._jit[key]

    def _pathbuf_update(self, T: int):
        """Donated in-place row update of the path buffer (avoids a full
        functional copy per backtraced op)."""
        import jax
        import jax.numpy as jnp

        key = ("pbupd", T)
        if key not in self._jit:

            def f(pb, rows, off):
                return jax.lax.dynamic_update_slice(pb, rows, (off, jnp.int32(0)))

            self._jit[key] = self._jit_sharded(
                f, self._rep_sharding(), donate_argnums=(0,)
            )
        return self._jit[key]

    def _trace_fn(self, T: int, B: int):
        """Reverse walk through a chunk's backpointers, on device."""
        import jax
        import jax.numpy as jnp

        key = ("trace", T, B)
        if key not in self._jit:

            def run(ys, carry):  # ys [T, R+1, B, B]; carry [3] = (i2, j2, r2)
                def f(c, bp):
                    i2, j2, r2 = c[0], c[1], c[2]
                    packed = bp[r2, i2, j2]
                    pi = packed & 0xFFF
                    pj = (packed >> 12) & 0xFFF
                    wu = (packed >> 24) & 1
                    wv = (packed >> 25) & 1
                    row = jnp.stack([pi, pj, wu, wv])
                    return jnp.stack([pi, pj, r2 - wu - wv]), row

                carry2, rows = jax.lax.scan(f, carry, ys, reverse=True)
                return carry2, rows  # rows [T, 4] aligned with ys order

            rep = self._rep_sharding()
            self._jit[key] = self._jit_sharded(run, (rep, rep))
        return self._jit[key]

    # ---------------- staging ----------------
    def ship(self):
        """Copy the transition stacks to the device and wait for them."""
        import jax

        jax.block_until_ready(self._ship())

    def compile(self):
        """Compile every executable run() calls, ahead of its first call.

        With a mesh the executables compile at their first call instead:
        their input shardings come from the committed arrays."""
        if self.mesh is not None:
            return
        import jax
        import jax.numpy as jnp

        small, big = self._ship()
        R, ops = self.R, self.ops

        def i32(*shape):
            return jax.ShapeDtypeStruct(shape, jnp.int32)

        def state(B):
            return i32(R + 1, B, B)

        pb = i32(max(sum(op.T for op in ops), 1), 4)
        todo = {}
        B_prev = ops[0].shape[0] if ops else self.small[0]
        for op in ops:
            B = op.shape[0]
            if B != B_prev:
                todo[("resize", B_prev, B)] = (
                    self._resize_fn(B_prev, B), (state(B_prev), state(B_prev)))
            B_prev = B
            if op.kind == "scan":
                for with_bp in (False, True):
                    todo[("scan", op.T, with_bp)] = (
                        self._scan_fn(op.T, with_bp),
                        (small, state(B), state(B), i32()))
            else:
                todo[("big", op.shape)] = (
                    self._big_fn(op.shape),
                    (big[op.shape], state(B), state(B), i32()))
            todo[("trace", op.T, B)] = (
                self._trace_fn(op.T, B), (i32(op.T, R + 1, B, B), i32(3)))
            todo[("pbupd", op.T)] = (
                self._pathbuf_update(op.T), (pb, i32(op.T, 4), i32()))
        todo["finalize"] = (
            self._finalize_fn(), (state(B_prev), state(B_prev), pb))
        for key, (fn, args) in todo.items():
            self._jit[key] = fn.lower(*args).compile()

    def measure_passes(self, passes: int = 1):
        """Forward-pass walls after one warm-up pass; each pass is ended
        by a device-to-host fetch of the sink value.

        Returns ([wall_0..wall_{n-1}], sink_value)."""
        import time as _time

        small, big = self._ship()
        ops = self.ops
        R = self.R

        def one():
            B_cur = ops[0].shape[0] if ops else self.small[0]
            V, SH = self._initial_state(B_cur)
            t0 = _time.perf_counter()
            for op in ops:
                if op.shape[0] != B_cur:
                    V, SH = self._resize_fn(B_cur, op.shape[0])(V, SH)
                    B_cur = op.shape[0]
                if op.kind == "scan":
                    V, SH, _ = self._scan_fn(op.T, False)(
                        small, V, SH, np.int32(op.start)
                    )
                else:
                    V, SH, _ = self._big_fn(op.shape)(
                        big[op.shape], V, SH, np.int32(op.start)
                    )
            v = int(np.asarray(V[R, 0, 0]))
            return _time.perf_counter() - t0, v

        one()
        walls, v = [], None
        for _ in range(max(passes, 1)):
            w, v = one()
            walls.append(w)
        return walls, v

    # ---------------- driver ----------------
    def run(self, verbose: bool = False):
        import sys
        import time as _time

        import jax
        import jax.numpy as jnp

        def vlog(msg):
            if verbose:
                print(f"[devdp {_time.time()-_t0:7.1f}s] {msg}",
                      file=sys.stderr, flush=True)

        _t0 = _time.time()

        R = self.R
        small, big = self._ship()
        SB = self.small[0]
        ops = self.ops

        def op_B(op):
            return op.shape[0]

        # forward with checkpoints
        B_cur = op_B(ops[0]) if ops else SB
        V, SH = self._initial_state(B_cur)

        ckpts: dict[int, tuple] = {0: (V, SH, B_cur)}
        for oi, op in enumerate(ops):
            nb = op_B(op)
            if nb != B_cur:
                V, SH = self._resize_fn(B_cur, nb)(V, SH)
                B_cur = nb
            if op.kind == "scan":
                V, SH, _ = self._scan_fn(op.T, False)(
                    small, V, SH, np.int32(op.start)
                )
            else:
                V, SH, _ = self._big_fn(op.shape)(
                    big[op.shape], V, SH, np.int32(op.start)
                )
            if (oi + 1) % self.ckpt_every == 0 and oi + 1 < len(ops):
                ckpts[oi + 1] = (V, SH, B_cur)
            if (oi + 1) % self.throttle == 0:
                # bound the async queue depth: an unbounded enqueue-ahead
                # keeps every intermediate buffer alive simultaneously and
                # stalls the device allocator
                V.block_until_ready()
            if verbose and (oi + 1) % 1000 == 0:
                vlog(f"forward op {oi+1}/{len(ops)}")

        n_rows = sum(op.T for op in ops)
        path_buf = jnp.zeros((max(n_rows, 1), 4), jnp.int32)
        carry = jnp.array([0, 0, R], jnp.int32)

        # backward: replay spans (recompute with bp), trace on device
        row_offsets = []
        acc = 0
        for op in ops:
            row_offsets.append(acc)
            acc += op.T
        vlog(f"forward enqueued ({len(ops)} ops); starting backward")
        span_starts = sorted(ckpts.keys(), reverse=True)
        span_end = len(ops)
        for si, s in enumerate(span_starts):
            if verbose and si % 20 == 0:
                vlog(f"backward span {si}/{len(span_starts)}")
            Vc, SHc, Bc = ckpts[s]
            seg = []
            B_run = Bc
            Vr, SHr = Vc, SHc
            for oi in range(s, span_end):
                op = ops[oi]
                nb = op_B(op)
                if nb != B_run:
                    Vr, SHr = self._resize_fn(B_run, nb)(Vr, SHr)
                    B_run = nb
                if op.kind == "scan":
                    Vr, SHr, ys = self._scan_fn(op.T, True)(
                        small, Vr, SHr, np.int32(op.start)
                    )
                else:
                    Vr, SHr, ys = self._big_fn(op.shape)(
                        big[op.shape], Vr, SHr, np.int32(op.start)
                    )
                    ys = ys[None]
                seg.append((oi, ys))
            for oi, ys in reversed(seg):
                op = ops[oi]
                carry, rows = self._trace_fn(op.T, op_B(op))(ys, carry)
                path_buf = self._pathbuf_update(op.T)(
                    path_buf, rows, np.int32(row_offsets[oi])
                )
            span_end = s
            if (si + 1) % self.throttle_spans == 0:
                carry.block_until_ready()  # queue-depth bound (see forward)

        # one device-to-host transfer
        vlog("all ops enqueued; synchronising")
        out = np.asarray(self._finalize_fn()(V, SH, path_buf))
        sink_val = int(out[0])
        sink_shet = int(out[1])
        path = out[2:].reshape(-1, 4)

        # assemble transitions (same contract as solver.diploid tiers)
        per_level = {}
        acc = 0
        for op in ops:
            for t, gid in enumerate(op.rows):
                if gid >= 0:
                    per_level[gid + 1] = path[acc + t]
            acc += op.T
        L1 = len(self.transitions)
        transitions = []
        i2, j2 = 0, 0
        for l in range(L1, 0, -1):
            pi, pj, wu, wv = (int(x) for x in per_level[l])
            transitions.append((l, pi, pj, i2, j2, wu, wv))
            i2, j2 = pi, pj
        transitions.reverse()
        return sink_val, sink_shet, transitions
