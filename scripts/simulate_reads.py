#!/usr/bin/env python3
"""Simulate short reads from a GFA's haplotype walks.

The reference evaluation uses real HPRC read sets that are not shipped
(README.md:34 references test/HG002.mhc.2x.fq.gz, absent from test/).
This simulator regenerates diploid-like read sets from any walk-bearing
GFA so the diploid pipeline can be exercised and golden-tested
deterministically.

Example (the HG002 diploid smoke config, reference README.md:34):
  scripts/simulate_reads.py -g test/MHC_4.gfa.gz -s HG002.1 -s HG002.2 \
      -c 2.0 -l 150 --seed 7 -o HG002.sim.2x.fq
"""

from __future__ import annotations

import argparse
import gzip
import os
import sys

import numpy as np

_COMP = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def simulate(fh, walks, coverage: float, length: int, error_rate: float,
             rng) -> int:
    """Write reads sampled uniformly from each (name, sequence) walk at
    ``coverage``, half of them reverse-complemented, with substitution
    errors at ``error_rate``. Returns the number of reads written."""
    n_total = 0
    bases = np.frombuffer(b"ACGT", np.uint8)
    for name, seq in walks:
        n_reads = int(len(seq) * coverage / length)
        starts = rng.integers(0, max(len(seq) - length, 1), n_reads)
        flips = rng.random(n_reads) < 0.5
        for i, (st, fl) in enumerate(zip(starts.tolist(), flips.tolist())):
            r = seq[st : st + length]
            if error_rate > 0:
                arr = np.frombuffer(r.encode(), np.uint8).copy()
                errs = np.nonzero(rng.random(len(arr)) < error_rate)[0]
                arr[errs] = bases[rng.integers(0, 4, len(errs))]
                r = arr.tobytes().decode()
            if fl:
                r = revcomp(r)
            fh.write(f"@sim_{name}_{i}\n{r}\n+\n{'I' * len(r)}\n")
            n_total += 1
    return n_total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-g", "--gfa", required=True)
    ap.add_argument("-s", "--sample", action="append", required=True,
                    help="walk name (sample.hap), repeatable")
    ap.add_argument("-c", "--coverage", type=float, default=2.0)
    ap.add_argument("-l", "--length", type=int, default=150)
    ap.add_argument("-e", "--error-rate", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("-o", "--out", required=True)
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from dipgenie_tpu.graph.pangenome import PangenomeIndex
    from dipgenie_tpu.io.gfa import read_gfa

    index = PangenomeIndex.from_gfa(read_gfa(args.gfa))
    name2id = {n: i for i, n in enumerate(index.hap_id2name)}
    walks = []
    for sample in args.sample:
        if sample not in name2id:
            sys.exit(f"unknown walk '{sample}'; have {index.hap_id2name}")
        walks.append((sample, index.haplotype_seq(name2id[sample]).upper()))
    rng = np.random.default_rng(args.seed)
    opener = gzip.open if args.out.endswith(".gz") else open
    with opener(args.out, "wt") as fh:
        n_total = simulate(fh, walks, args.coverage, args.length,
                           args.error_rate, rng)
    print(f"wrote {n_total} reads to {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
