"""Multi-device sharding: jax.sharding Mesh + shard_map helpers.

The reference is single-process OpenMP (SURVEY §2.3); there is no
distributed design to port. Two axes:

  * **dp (data parallel)** — reads are sharded across devices; each
    device sketches its shard with the batched minimizer kernel
    (ops/sketch_jax.py) and joins hashes against a *replicated* sorted
    haplotype-minimizer table; per-table-slot match counts (the
    spectrum-side reduction of solver.cpp:533-575) merge with a single
    `psum` over the dp axis.
  * **tp** — the chunked device DP tier (ops/diploid_jax.py) shards the
    diploid pair-DP state V[(R+1), K, K] over the destination-row axis
    (sharded_dp_level_step below, or mesh= on DeviceDiploidDP).

Haplotype-expanded graphs are small next to device memory (the MHC
graph's DP inputs are ~100 MB), so the graph index is replicated per
device and only reads and states are sharded. No CLI path builds a mesh
yet; these helpers are tested on a virtual CPU device mesh.
"""

from __future__ import annotations

from functools import partial

import numpy as np


def make_mesh(n_dp: int | None = None, n_tp: int = 1, devices=None):
    import jax
    from jax.sharding import Mesh

    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_dp is None:
        n_dp = n // n_tp
    assert n_dp * n_tp <= n, f"mesh {n_dp}x{n_tp} needs {n_dp*n_tp} devices, have {n}"
    dev_array = np.asarray(devices[: n_dp * n_tp]).reshape(n_dp, n_tp)
    return Mesh(dev_array, ("dp", "tp"))


def sharded_sketch_count_step(mesh, codes, lens, table_hi, table_lo,
                              k: int, w: int, max_dup: int = 4):
    """Data-parallel sketch + anchor-count with a psum merge.

    codes [B, L] uint8 (B divisible by dp size), lens [B];
    table_hi/lo: uint32 arrays, the haplotype minimizer hashes sorted by
    (hi, lo). Returns match counts per table slot [M] (replicated) and
    per-read anchor counts [B].
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    from ..ops.sketch_jax import batch_minimizer_kernel

    M = table_hi.shape[0]

    def local(codes_l, lens_l, thi, tlo):
        hh, hl, emit, _ = batch_minimizer_kernel(codes_l, lens_l, k, w)
        # match (hh, hl) against the sorted table: bucket by hi, probe lo
        start = jnp.searchsorted(thi, hh, side="left")
        slot = jnp.full(hh.shape, -1, jnp.int32)
        for d in range(max_dup):
            idx = jnp.clip(start + d, 0, M - 1)
            ok = (start + d < M) & (thi[idx] == hh) & (tlo[idx] == hl)
            slot = jnp.where((slot < 0) & ok, idx.astype(jnp.int32), slot)
        matched = emit & (slot >= 0)
        counts = jnp.zeros(M, jnp.int32).at[jnp.where(matched, slot, 0)].add(
            matched.astype(jnp.int32)
        )
        counts = jax.lax.psum(counts, "dp")
        per_read = matched.sum(axis=1).astype(jnp.int32)
        return counts, per_read

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("dp", None), P("dp"), P(), P()),
        out_specs=(P(), P("dp")),
        check_vma=False,
    )
    return fn(codes, lens, table_hi, table_lo)


def sharded_dp_level_step(mesh, V, SH, xs, R: int, P_slots: int):
    """One diploid DP level transition with the destination tile sharded
    over the tp axis (pair-tile parallelism for the DP hot loop)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops.diploid_jax import _step_body

    def step(V, SH, xs):
        (V2, SH2), bp = _step_body(R, P_slots, (V, SH), xs)
        return V2, SH2, bp

    state_sharding = NamedSharding(mesh, P(None, "tp", None))
    rep = NamedSharding(mesh, P())
    fn = jax.jit(
        step,
        in_shardings=(state_sharding, state_sharding, rep),
        out_shardings=(state_sharding, state_sharding, state_sharding),
    )
    return fn(V, SH, xs)
