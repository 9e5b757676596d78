#!/usr/bin/env python3
"""Cut a slice of a levelized expanded-graph CSR into a standalone DP
instance with its exact-tier oracle (the tests/data/mhc_slice*.npz
files were cut this way from the MHC_4 test graph with CHM13 reads).

Runs the front end on GFA + READS (-p2 -R18 defaults), takes NL levels
from level l0, appends a width-1 sink level reachable from every level
of the last sliced level via 0-weight edges, compacts colour ids, and
stores the slice CSR with the exact tier's (value, s_het, transitions),
so tests can check a device tier against it without re-running the
exact tier.

Usage: python scripts/make_mhc_slice.py GFA READS [NL] [out.npz] [l0]
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def slice_csr(arrs, NL: int, l0: int = 0):
    """(8 CSR arrays) -> (8 slice arrays, chb bool array).

    Slices levels [l0, l0+NL). With l0 > 0 a synthetic width-1 source
    level is prepended, reaching every level-l0 vertex via a 0-weight
    edge (mirroring the synthetic sink appended at the far end), so
    mid-graph regions — e.g. the wide-level band starting at MHC level
    64 — can be extracted as standalone DP instances.
    """
    (level_ptr, adj_ptr, adj_v, adj_w,
     hom_ptr, hom_colors, het_ptr, het_colors) = [np.asarray(a) for a in arrs]
    v_lo = int(level_ptr[l0])        # first vertex of level l0
    V0 = int(level_ptr[l0 + NL]) - v_lo  # vertices in the sliced levels
    src_w = 1 if l0 > 0 else 0       # synthetic source vertex count
    lp = np.concatenate([
        [0],
        *([[src_w]] if src_w else []),
        level_ptr[l0 + 1 : l0 + NL + 1] - v_lo + src_w,
        [V0 + src_w + 1],
    ]).astype(np.int64)

    b_last = int(level_ptr[l0 + NL - 1]) - v_lo  # first vtx of last level
    # adjacency: synthetic source -> every level-l0 vertex (w=0), then
    # kept in-slice edges for levels l0..l0+NL-2, then sink edges
    w0 = int(level_ptr[l0 + 1]) - v_lo           # width of level l0
    e_lo = int(adj_ptr[v_lo])
    keep_e = int(adj_ptr[v_lo + b_last]) - e_lo
    new_deg = np.concatenate([
        *([np.full(src_w, w0, np.int64)] if src_w else []),
        np.diff(adj_ptr[v_lo : v_lo + b_last + 1]),
        np.full(V0 - b_last, 1, np.int64),   # one sink edge each
        [0],                                  # sink itself
    ])
    ap = np.zeros(V0 + src_w + 2, np.int64)
    np.cumsum(new_deg, out=ap[1:])
    av = np.concatenate([
        *([np.arange(src_w, src_w + w0, dtype=np.int32)] if src_w else []),
        adj_v[e_lo : e_lo + keep_e].astype(np.int32) - v_lo + src_w,
        np.full(V0 - b_last, V0 + src_w, np.int32),
    ])
    aw = np.concatenate([
        *([np.zeros(w0, np.int8)] if src_w else []),
        adj_w[e_lo : e_lo + keep_e].astype(np.int8),
        np.zeros(V0 - b_last, np.int8),
    ])

    # colours: slice CSRs + compact remap preserving hom/het classes
    h_lo = int(hom_ptr[v_lo])
    t_lo = int(het_ptr[v_lo])
    hp = np.concatenate([
        np.zeros(src_w, np.int64),
        hom_ptr[v_lo : v_lo + V0 + 1] - h_lo,
        [hom_ptr[v_lo + V0] - h_lo],
    ]).astype(np.int64)
    tp = np.concatenate([
        np.zeros(src_w, np.int64),
        het_ptr[v_lo : v_lo + V0 + 1] - t_lo,
        [het_ptr[v_lo + V0] - t_lo],
    ]).astype(np.int64)
    hc = hom_colors[h_lo : int(hom_ptr[v_lo + V0])].astype(np.int64)
    tc = het_colors[t_lo : int(het_ptr[v_lo + V0])].astype(np.int64)
    uh = np.unique(hc)
    ut = np.unique(tc)
    hc2 = np.searchsorted(uh, hc).astype(np.int32)
    tc2 = (len(uh) + np.searchsorted(ut, tc)).astype(np.int32)
    chb = np.zeros(len(uh) + len(ut), bool)
    chb[: len(uh)] = True
    return (lp, ap, av, aw, hp, hc2, tp, tc2), chb


def csr_to_expanded(arrs, chb):
    """Rebuild an ExpandedGraph view of a leveled CSR (DP fields only)."""
    from dipgenie_tpu.graph.expanded import ExpandedGraph

    (lp, ap, av, aw, hp, hc, tp, tc) = arrs
    L = len(lp) - 1
    n = int(lp[-1])
    level = np.repeat(np.arange(L), np.diff(lp)).tolist()
    g = ExpandedGraph(
        adj_list=[
            [(int(av[e]), int(aw[e])) for e in range(int(ap[v]), int(ap[v + 1]))]
            for v in range(n)
        ],
        color=[
            sorted(
                [int(c) for c in hc[int(hp[v]) : int(hp[v + 1])]]
                + [int(c) for c in tc[int(tp[v]) : int(tp[v + 1])]]
            )
            for v in range(n)
        ],
        original_vertex=[[v] for v in range(n)],
        haplotype=[0] * n,
        level=level,
        vertices_in_level=[
            list(range(int(lp[l]), int(lp[l + 1]))) for l in range(L)
        ],
    )
    return g


def main() -> int:
    gfa, reads = sys.argv[1], sys.argv[2]
    NL = int(sys.argv[3]) if len(sys.argv) > 3 else 500
    out = sys.argv[4] if len(sys.argv) > 4 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "data", "mhc_slice_csr.npz",
    )
    l0 = int(sys.argv[5]) if len(sys.argv) > 5 else 0
    R = 18

    from dipgenie_tpu.solver.diploid import csr_arrays
    from dipgenie_tpu.solver.pipeline import Pipeline, PipelineConfig

    p = Pipeline(gfa, reads, os.devnull, PipelineConfig(verbose=False))
    p.compute_anchors()
    g, color_homo_bv, _ = p.diploid_graph()
    sl, chb = slice_csr(csr_arrays(g, color_homo_bv), NL, l0)
    g = csr_to_expanded(sl, chb)

    from dipgenie_tpu.solver.diploid import build_color_masks, _forward_exact

    Hm, Tm = build_color_masks(g, chb.tolist())
    ev, es, etr = _forward_exact(g, R, Hm, Tm)
    print(f"slice NL={NL}: vertices={int(sl[0][-1])}, "
          f"colors={len(chb)}, exact=({ev},{es}), {len(etr)} transitions")

    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(
        out,
        level_ptr=sl[0], adj_ptr=sl[1], adj_v=sl[2], adj_w=sl[3],
        hom_ptr=sl[4], hom_colors=sl[5], het_ptr=sl[6], het_colors=sl[7],
        chb=chb, R=np.int64(R),
        oracle_value=np.int64(ev), oracle_shet=np.int64(es),
        oracle_transitions=np.asarray(etr, np.int64),
    )
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
