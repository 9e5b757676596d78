"""Device minimizer sketching: batched canonical (w,k)-minimizers
with on-device MurmurHash3.

Same semantics as the host scanner (sketch/minimizers.py, reference
src/solver.cpp:277-412) for pure-ACGT sequences:

  * canonical k-mer = min(forward, revcomp) in string order, represented
    as left-aligned 2-bit packings split across two uint32 lanes
    (numeric (hi, lo) order == string order);
  * per-window minimum with rightmost tie (the deque ``>=`` pop rule);
  * consecutive-duplicate suppression (by k-mer value — equal values hash
    equally; the reference dedups by hash, identical modulo 64-bit hash
    collisions between adjacent minimizers);
  * MurmurHash3_x64_128 XOR-fold computed on device with 64-bit
    arithmetic emulated on uint32 pairs (JAX's default 32-bit mode has
    no uint64), bit-identical to the host/native hashes — asserted in
    tests.

Inputs are 2-bit base codes (A=0,C=1,G=2,T=3); reads containing other
characters must take the host path (the pipeline routes them there).

Everything here is jit-friendly: static shapes, no data-dependent
control flow — masking handles ragged read lengths.
"""

from __future__ import annotations

from functools import partial

import numpy as np


def _jnp():
    import jax.numpy as jnp

    return jnp


# ---------------- 64-bit arithmetic on uint32 pairs ----------------

def _mul32x32(a, b):
    """uint32 × uint32 → (hi, lo) full 64-bit product."""
    jnp = _jnp()
    m16 = jnp.uint32(0xFFFF)
    a0, a1 = a & m16, a >> jnp.uint32(16)
    b0, b1 = b & m16, b >> jnp.uint32(16)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    t = (p00 >> jnp.uint32(16)) + (p01 & m16) + (p10 & m16)
    lo = (p00 & m16) | (t << jnp.uint32(16))
    hi = p11 + (p01 >> jnp.uint32(16)) + (p10 >> jnp.uint32(16)) + (
        t >> jnp.uint32(16)
    )
    return hi, lo


def _mul64(ah, al, bh, bl):
    hi, lo = _mul32x32(al, bl)
    return hi + al * bh + ah * bl, lo


def _add64(ah, al, bh, bl):
    jnp = _jnp()
    lo = al + bl
    carry = (lo < al).astype(jnp.uint32)
    return ah + bh + carry, lo


def _rotl64(h, l, r: int):
    jnp = _jnp()
    r = r % 64
    if r == 0:
        return h, l
    if r < 32:
        rr = jnp.uint32(r)
        ri = jnp.uint32(32 - r)
        return (h << rr) | (l >> ri), (l << rr) | (h >> ri)
    if r == 32:
        return l, h
    rr = jnp.uint32(r - 32)
    ri = jnp.uint32(64 - r)
    return (l << rr) | (h >> ri), (h << rr) | (l >> ri)


def _shr64(h, l, s: int):
    jnp = _jnp()
    if s == 0:
        return h, l
    if s < 32:
        ss = jnp.uint32(s)
        return h >> ss, (l >> ss) | (h << jnp.uint32(32 - s))
    return h * jnp.uint32(0), h >> jnp.uint32(s - 32)


def _xor64(ah, al, bh, bl):
    return ah ^ bh, al ^ bl


_C1 = (0x87C37B91, 0x114253D5)
_C2 = (0x4CF5AD43, 0x2745937F)
_F1 = (0xFF51AFD7, 0xED558CCD)
_F2 = (0xC4CEB9FE, 0x1A85EC53)


def _const(c):
    jnp = _jnp()
    return jnp.uint32(c[0]), jnp.uint32(c[1])


def _fmix64(h, l):
    jnp = _jnp()
    h, l = _xor64(h, l, *_shr64(h, l, 33))
    h, l = _mul64(h, l, *_const(_F1))
    h, l = _xor64(h, l, *_shr64(h, l, 33))
    h, l = _mul64(h, l, *_const(_F2))
    h, l = _xor64(h, l, *_shr64(h, l, 33))
    return h, l


def murmur_fold64_device(byte_cols: list, length: int):
    """MurmurHash3 x64_128 XOR-fold of fixed-length messages.

    byte_cols: list of `length` uint32 arrays (same shape), the message
    bytes. Returns (hash_hi, hash_lo) uint32 arrays."""
    jnp = _jnp()
    z = jnp.zeros_like(byte_cols[0])
    c1h, c1l = _const(_C1)
    c2h, c2l = _const(_C2)
    h1h, h1l = z, z
    h2h, h2l = z, z
    nblocks = length // 16

    def le64(cols):
        lo = cols[0] | (cols[1] << jnp.uint32(8)) | (cols[2] << jnp.uint32(16)) | (
            cols[3] << jnp.uint32(24)
        )
        hi = cols[4] | (cols[5] << jnp.uint32(8)) | (cols[6] << jnp.uint32(16)) | (
            cols[7] << jnp.uint32(24)
        )
        return hi, lo

    for b in range(nblocks):
        k1h, k1l = le64(byte_cols[16 * b : 16 * b + 8])
        k2h, k2l = le64(byte_cols[16 * b + 8 : 16 * b + 16])
        k1h, k1l = _mul64(k1h, k1l, c1h, c1l)
        k1h, k1l = _rotl64(k1h, k1l, 31)
        k1h, k1l = _mul64(k1h, k1l, c2h, c2l)
        h1h, h1l = h1h ^ k1h, h1l ^ k1l
        h1h, h1l = _rotl64(h1h, h1l, 27)
        h1h, h1l = _add64(h1h, h1l, h2h, h2l)
        h1h, h1l = _mul64(h1h, h1l, jnp.uint32(0), jnp.uint32(5))
        h1h, h1l = _add64(h1h, h1l, jnp.uint32(0), jnp.uint32(0x52DCE729))
        k2h, k2l = _mul64(k2h, k2l, c2h, c2l)
        k2h, k2l = _rotl64(k2h, k2l, 33)
        k2h, k2l = _mul64(k2h, k2l, c1h, c1l)
        h2h, h2l = h2h ^ k2h, h2l ^ k2l
        h2h, h2l = _rotl64(h2h, h2l, 31)
        h2h, h2l = _add64(h2h, h2l, h1h, h1l)
        h2h, h2l = _mul64(h2h, h2l, jnp.uint32(0), jnp.uint32(5))
        h2h, h2l = _add64(h2h, h2l, jnp.uint32(0), jnp.uint32(0x38495AB5))

    tail = byte_cols[nblocks * 16 :]
    nt = length & 15
    if nt > 8:
        k2h, k2l = z, z
        for i in range(nt - 1, 7, -1):
            sh = 8 * (i - 8)
            if sh < 32:
                k2l = k2l ^ (tail[i] << jnp.uint32(sh)) if sh else k2l ^ tail[i]
                if sh > 24:  # byte straddles? sh multiple of 8 ≤ 24 never straddles
                    pass
            else:
                k2h = k2h ^ (tail[i] << jnp.uint32(sh - 32))
        k2h, k2l = _mul64(k2h, k2l, c2h, c2l)
        k2h, k2l = _rotl64(k2h, k2l, 33)
        k2h, k2l = _mul64(k2h, k2l, c1h, c1l)
        h2h, h2l = h2h ^ k2h, h2l ^ k2l
    if nt > 0:
        k1h, k1l = z, z
        for i in range(min(nt, 8) - 1, -1, -1):
            sh = 8 * i
            if sh < 32:
                k1l = k1l ^ (tail[i] << jnp.uint32(sh)) if sh else k1l ^ tail[i]
            else:
                k1h = k1h ^ (tail[i] << jnp.uint32(sh - 32))
        k1h, k1l = _mul64(k1h, k1l, c1h, c1l)
        k1h, k1l = _rotl64(k1h, k1l, 31)
        k1h, k1l = _mul64(k1h, k1l, c2h, c2l)
        h1h, h1l = h1h ^ k1h, h1l ^ k1l

    h1h, h1l = h1h, h1l ^ jnp.uint32(length)
    h2h, h2l = h2h, h2l ^ jnp.uint32(length)
    h1h, h1l = _add64(h1h, h1l, h2h, h2l)
    h2h, h2l = _add64(h2h, h2l, h1h, h1l)
    h1h, h1l = _fmix64(h1h, h1l)
    h2h, h2l = _fmix64(h2h, h2l)
    h1h, h1l = _add64(h1h, h1l, h2h, h2l)
    h2h, h2l = _add64(h2h, h2l, h1h, h1l)
    return h1h ^ h2h, h1l ^ h2l


# ---------------- batched minimizer kernel ----------------

_CHARS = np.array([65, 67, 71, 84], np.uint32)  # 'A','C','G','T'


def encode_reads(seqs: list[str], pad_to: int | None = None):
    """Host-side: uppercase 2-bit encode; returns (codes [B,L], lens [B],
    pure_mask [B]). Non-ACGT reads get pure_mask False (host path)."""
    code = np.full(256, 255, np.uint8)
    for i, c in enumerate(b"ACGT"):
        code[c] = i
        code[c + 32] = i
    L = pad_to or max((len(s) for s in seqs), default=1)
    B = len(seqs)
    out = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    pure = np.zeros(B, bool)
    for i, s in enumerate(seqs):
        b = np.frombuffer(s[:L].encode("latin-1"), np.uint8)
        cs = code[b]
        lens[i] = len(b)
        pure[i] = not np.any(cs == 255)
        out[i, : len(b)] = np.where(cs == 255, 0, cs)
    return out, lens, pure


def batch_minimizer_kernel(codes, lens, k: int, w: int):
    """Jittable batched sketch. codes [B, L] uint8 (2-bit), lens [B].

    Returns per-window arrays [B, NW] (NW = L-k-w+2):
      hash_hi, hash_lo (uint32), emit (bool), minpos (int32).
    Emitted minimizers of read b = rows where emit & window valid."""
    import jax

    jnp = _jnp()
    B, L = codes.shape
    nk = L - k + 1
    nw = nk - w + 1
    c = codes.astype(jnp.uint32)

    k1 = min(k, 16)
    k2 = k - k1

    def pack(cols, n):
        """Left-aligned 2-bit pack of n (≤16) code columns [B, nk]."""
        acc = jnp.zeros((B, nk), jnp.uint32)
        for j in range(n):
            acc = (acc << jnp.uint32(2)) | cols[j]
        return acc << jnp.uint32(2 * (16 - n))

    fcols = [c[:, j : j + nk] for j in range(k)]
    rcols = [jnp.uint32(3) - fcols[k - 1 - j] for j in range(k)]
    fhi = pack(fcols[:k1], k1)
    flo = pack(fcols[k1:], k2) if k2 else jnp.zeros((B, nk), jnp.uint32)
    rhi = pack(rcols[:k1], k1)
    rlo = pack(rcols[k1:], k2) if k2 else jnp.zeros((B, nk), jnp.uint32)

    is_rc = (rhi < fhi) | ((rhi == fhi) & (rlo < flo))
    chi = jnp.where(is_rc, rhi, fhi)
    clo = jnp.where(is_rc, rlo, flo)

    # invalidate k-mers beyond read end: force to max so they never win
    pos_idx = jnp.arange(nk, dtype=jnp.int32)[None, :]
    kvalid = pos_idx <= (lens[:, None] - k)
    FMAX = jnp.uint32(0xFFFFFFFF)
    chi = jnp.where(kvalid, chi, FMAX)
    clo = jnp.where(kvalid, clo, FMAX)

    # rolling window min, rightmost tie: iterate offsets ascending and
    # prefer <= (later equal wins)
    bh = chi[:, :nw]
    bl = clo[:, :nw]
    bpos = jnp.broadcast_to(jnp.arange(nw, dtype=jnp.int32)[None, :], (B, nw))
    for s in range(1, w):
        ch_, cl_ = chi[:, s : s + nw], clo[:, s : s + nw]
        take = (ch_ < bh) | ((ch_ == bh) & (cl_ <= bl))
        bh = jnp.where(take, ch_, bh)
        bl = jnp.where(take, cl_, bl)
        bpos = jnp.where(take, jnp.arange(s, s + nw, dtype=jnp.int32)[None, :], bpos)

    wvalid = jnp.arange(nw, dtype=jnp.int32)[None, :] <= (lens[:, None] - k - w + 1)
    emit = jnp.ones((B, nw), bool)
    if nw > 1:
        same = (bh[:, 1:] == bh[:, :-1]) & (bl[:, 1:] == bl[:, :-1])
        emit = jnp.concatenate([emit[:, :1], ~same], axis=1)
    emit = emit & wvalid

    # hash the winning canonical k-mer per window
    whi = bh
    wlo = bl

    def code_at(j):
        if j < k1:
            return (whi >> jnp.uint32(2 * (15 - j))) & jnp.uint32(3)
        return (wlo >> jnp.uint32(2 * (15 - (j - k1)))) & jnp.uint32(3)

    chars = jnp.asarray(_CHARS)
    byte_cols = [chars[code_at(j)] for j in range(k)]
    hh, hl = murmur_fold64_device(byte_cols, k)
    return hh, hl, emit, bpos


def sketch_long_sequence_device(seq: str, k: int, w: int):
    """Device sketch of one long (haplotype) sequence. Returns
    (hashes uint64, positions int64) identical to the host scanner.
    Falls back to the host path for non-ACGT sequences."""
    import jax

    from ..sketch.minimizers import sketch_sequence

    jnp = _jnp()
    codes, lens, pure = encode_reads([seq], len(seq))
    if not pure[0] or len(seq) < w + k - 1:
        m = sketch_sequence(seq, k, w)
        return m.hashes, m.positions
    hh, hl, emit, minpos = jax.jit(
        partial(batch_minimizer_kernel, k=k, w=w)
    )(jnp.asarray(codes), jnp.asarray(lens))
    hh = np.asarray(hh[0], np.uint64)
    hl = np.asarray(hl[0], np.uint64)
    em = np.asarray(emit[0])
    mp = np.asarray(minpos[0], np.int64)
    h64 = (hh << np.uint64(32)) | hl
    return h64[em], mp[em]


def sketch_reads_device(seqs: list[str], k: int, w: int, batch: int = 2048,
                        mesh=None):
    """Convenience wrapper: device sketch of many reads; returns list of
    per-read unique uint64 hash arrays (numpy). Non-ACGT reads fall back
    to the host scanner.

    With ``mesh`` (a jax.sharding.Mesh with a "dp" axis), the read batch
    is sharded over dp via shard_map: every device sketches its read
    shard with the same kernel, results gather back sharded-out — the
    data-parallel leg of the SURVEY §7.6 decomposition. Every call runs
    ``batch`` rows (rounded up to a dp multiple), so each read length
    bucket compiles once; padding rows are zero-length reads, which emit
    nothing."""
    import jax

    from ..sketch.minimizers import sketch_sequence

    jnp = _jnp()
    out: list[np.ndarray] = [None] * len(seqs)
    if mesh is None:
        jit_kernel = jax.jit(partial(batch_minimizer_kernel, k=k, w=w))
        n_dp = 1
    else:
        from jax.sharding import PartitionSpec as Pspec
        from jax import shard_map

        n_dp = mesh.shape["dp"]
        jit_kernel = jax.jit(
            shard_map(
                partial(batch_minimizer_kernel, k=k, w=w),
                mesh=mesh,
                in_specs=(Pspec("dp", None), Pspec("dp")),
                out_specs=(Pspec("dp", None), Pspec("dp", None),
                           Pspec("dp", None), Pspec("dp", None)),
                check_vma=False,
            )
        )

    idxs = [i for i, s in enumerate(seqs)]
    # bucket by padded length to limit compilation shapes
    def pad_len(n):
        p = 64
        while p < n:
            p *= 2
        return p

    groups: dict[int, list[int]] = {}
    for i in idxs:
        groups.setdefault(pad_len(len(seqs[i])), []).append(i)
    for plen, members in groups.items():
        for s0 in range(0, len(members), batch):
            chunk = members[s0 : s0 + batch]
            texts = [seqs[i] for i in chunk]
            texts += [""] * (-(-batch // n_dp) * n_dp - len(texts))
            codes, lens, pure = encode_reads(texts, plen)
            hh, hl, emit, _ = jit_kernel(jnp.asarray(codes), jnp.asarray(lens))
            hh = np.asarray(hh, np.uint64)
            hl = np.asarray(hl, np.uint64)
            em = np.asarray(emit)
            h64 = (hh << np.uint64(32)) | hl
            for row, i in enumerate(chunk):
                if not pure[row]:
                    out[i] = np.unique(sketch_sequence(seqs[i], k, w).hashes)
                else:
                    out[i] = np.unique(h64[row][em[row]])
    return out
