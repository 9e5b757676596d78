"""Device kernels (CPU backend): sketch/murmur bit-parity with the host
scanner, the native DP tier and the fused tier's guards against the
exact tier. The device tiers' parity grid is tests/test_device_dp_tiers.py."""

import random

import numpy as np
import pytest

from dipgenie_tpu.ops.sketch_jax import sketch_reads_device
from dipgenie_tpu.sketch.minimizers import sketch_sequence


def test_device_sketch_bit_parity():
    # k=17 exercises both the 16-byte murmur block path and the tail path
    # while keeping the XLA-CPU compile of the emulated-u64 graph fast;
    # k=31 parity on the GPU is a phase of chip_smoke.py.
    random.seed(42)
    seqs = []
    for _ in range(20):
        n = random.randint(40, 160)
        seqs.append("".join(random.choice("ACGT") for _ in range(n)))
    seqs.append("ACGTN" * 20)  # non-ACGT → host fallback path
    k, w = 17, 7
    dev = sketch_reads_device(seqs, k, w, batch=8)
    for i, s in enumerate(seqs):
        host = np.unique(sketch_sequence(s, k, w).hashes)
        assert np.array_equal(dev[i], host), i


def _random_leveled_graph(rng, L=12, kmax=5, ncolors=8):
    """Random levelized expanded-graph-shaped instance."""
    from dipgenie_tpu.graph.expanded import ExpandedGraph

    widths = [1] + [int(rng.integers(1, kmax + 1)) for _ in range(L - 2)] + [1]
    ids = []
    level_of = []
    for l, w in enumerate(widths):
        for _ in range(w):
            level_of.append(l)
    n = len(level_of)
    starts = np.cumsum([0] + widths)
    g = ExpandedGraph(
        adj_list=[[] for _ in range(n)],
        color=[[] for _ in range(n)],
        original_vertex=[[v] for v in range(n)],
        haplotype=[0] * n,
        level=list(level_of),
        vertices_in_level=[
            list(range(starts[l], starts[l + 1])) for l in range(L)
        ],
    )
    for l in range(L - 1):
        for u in range(starts[l], starts[l + 1]):
            deg = int(rng.integers(1, 3))
            for _ in range(deg):
                v = int(rng.integers(starts[l + 1], starts[l + 2]))
                g.adj_list[u].append((v, int(rng.random() < 0.3)))
        # every next-level vertex needs an in-edge for reachability variety
        for v in range(starts[l + 1], starts[l + 2]):
            if not any(v == t for u in range(starts[l], starts[l + 1])
                       for t, _ in g.adj_list[u]):
                u = int(rng.integers(starts[l], starts[l + 1]))
                g.adj_list[u].append((v, 0))
    for v in range(n):
        for c in rng.choice(ncolors, size=rng.integers(0, 4), replace=False):
            g.color[v].append(int(c))
        g.color[v].sort()
    return g


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_native_dp_matches_exact_tier(seed):
    from dipgenie_tpu import native
    from dipgenie_tpu.solver.diploid import (
        _forward_exact, _forward_native, build_color_masks,
    )

    if not native.available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(seed)
    g = _random_leveled_graph(rng)
    chb = [bool(x) for x in rng.random(8) < 0.4]
    R = 5
    Hm, Tm = build_color_masks(g, chb)
    ev, es, etr = _forward_exact(g, R, Hm, Tm)
    nv, ns, ntr = _forward_native(g, R, chb)
    assert (nv, ns) == (ev, es)
    assert ntr == etr


def test_fused_dp_high_indegree():
    """P >= 64 pred slots (tie_bits >= 12): the regime where the old
    packed-int32-key formulation overflowed; the lexicographic
    (value, tie) max must match the exact tier bit for bit."""
    from dipgenie_tpu.ops.diploid_fused import FusedDiploidDP, plan_fused
    from dipgenie_tpu.solver.diploid import (
        _forward_exact, build_color_masks, csr_arrays,
    )

    rng = np.random.default_rng(7)
    L, width = 5, 40
    widths = [1] + [width] * (L - 2) + [1]
    starts = np.cumsum([0] + widths)
    n = int(starts[-1])
    from dipgenie_tpu.graph.expanded import ExpandedGraph

    g = ExpandedGraph(
        adj_list=[[] for _ in range(n)],
        color=[[] for _ in range(n)],
        original_vertex=[[v] for v in range(n)],
        haplotype=[0] * n,
        level=[l for l, w in enumerate(widths) for _ in range(w)],
        vertices_in_level=[
            list(range(starts[l], starts[l + 1])) for l in range(L)
        ],
    )
    for l in range(L - 1):
        k2 = widths[l + 1]
        for u in range(starts[l], starts[l + 1]):
            # dense fan-out so next-level in-degree lands in the 64-slot
            # bucket (> 32 preds on the wide levels)
            for v in rng.choice(k2, size=min(k2, 36), replace=False):
                g.adj_list[u].append(
                    (int(starts[l + 1] + v), int(rng.random() < 0.2))
                )
    ncolors = 6
    for v in range(n):
        for c in rng.choice(ncolors, size=rng.integers(0, 3), replace=False):
            g.color[v].append(int(c))
        g.color[v].sort()
    chb = [bool(x) for x in rng.random(ncolors) < 0.5]
    R = 3

    Hm, Tm = build_color_masks(g, chb)
    ev, es, etr = _forward_exact(g, R, Hm, Tm)

    plan = plan_fused(*csr_arrays(g, chb), R)
    assert max(b.tie_bits for b in plan.buckets) >= 12
    fv, fs, ftr = FusedDiploidDP(plan).run()
    assert (fv, fs) == (ev, es)
    assert ftr == etr


def test_fused_plan_guards():
    """plan_fused raises clear errors instead of silently clamping."""
    from dipgenie_tpu.ops.diploid_fused import plan_fused
    from dipgenie_tpu.solver.diploid import csr_arrays

    rng = np.random.default_rng(3)
    g = _random_leveled_graph(rng, L=6, kmax=4, ncolors=5000)
    # flood one vertex with >4096 distinct colours -> W over the ladder
    g.color[2] = list(range(4097))
    chb = [True] * 5000
    with pytest.raises(ValueError, match="distinct colours"):
        plan_fused(*csr_arrays(g, chb), 5)
