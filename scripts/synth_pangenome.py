#!/usr/bin/env python3
"""Seeded pangenome graph and read-set generator.

Writes a GFA v1.1 (S, L and W lines) whose walks run over a random
backbone carrying SNP and indel bubbles, and a FASTQ of short reads
simulated from two of the walks (one diploid sample) with
``simulate_reads.py``'s sampler.

Sizes:

* ``mhc4``: the shapes of the reference's MHC_4 test graph
  (BASELINE.md:17-19): 5 walks over a 4.92 Mbp backbone with one bubble
  per ~150 bp (32,838 variant records / 4.92 Mbp), about 110k segments
  and 150k links. Reads: 150 bp at 2x per walk from the two walks of
  sample SYN1, the reference's diploid smoke config
  (simulate_reads.py's docstring).
* ``toy``: the same generator on a 6 kbp backbone, committed under
  ``tests/data/`` for the end-to-end tests.

The same seed gives the same bytes. Example:

  scripts/synth_pangenome.py --size mhc4 --seed 7 -o /tmp/mhc4
  # -> /tmp/mhc4.gfa, /tmp/mhc4.fq
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from simulate_reads import simulate  # noqa: E402

SIZES = {
    "mhc4": dict(length=4_920_000, spacing=150),
    "toy": dict(length=6_000, spacing=150),
}
WALKS = (("REF", 0), ("SYN1", 1), ("SYN1", 2), ("SYN2", 1), ("SYN2", 2))
READ_WALKS = ("SYN1.1", "SYN1.2")  # the diploid sample the reads come from
COVERAGE = 2.0  # per walk
READ_LEN = 150
_BASES = np.frombuffer(b"ACGT", np.uint8)


def _random_seq(rng, n: int) -> str:
    return _BASES[rng.integers(0, 4, n)].tobytes().decode()


def make_graph(rng, length: int, spacing: int, n_walks: int = len(WALKS)):
    """Backbone with bubbles -> (segment seqs, links, per-walk segment ids).

    Segments are numbered in backbone order: chunk 0, the alleles of
    site 0, chunk 1, ... Each site is a SNP (70%) or an indel of up to
    10 bp (30%), and 40% of sites carry a third allele; an empty allele
    is a deletion edge from chunk to chunk. Every allele is on at least
    one walk."""
    backbone = _random_seq(rng, length)
    gaps = rng.integers(spacing // 2 + 1, spacing + spacing // 2, length // spacing + 1)
    pos = np.cumsum(gaps)
    pos = pos[pos < length - spacing]
    n = len(pos)
    is_snp = rng.random(n) < 0.7
    tri = rng.random(n) < 0.4
    ref_len = np.where(is_snp, 1, rng.integers(1, 11, n))

    segs: list[str] = []
    links: list[tuple[int, int]] = []
    paths: list[list[int]] = [[] for _ in range(n_walks)]
    cur = 0  # backbone offset of the current chunk
    prev_chunk = -1
    for s in range(n):
        p, rl = int(pos[s]), int(ref_len[s])
        segs.append(backbone[cur:p])
        chunk = len(segs) - 1
        if prev_chunk >= 0:
            _link_site(links, paths, site_alleles, site_walks, prev_chunk, chunk)
        for w in range(n_walks):
            paths[w].append(chunk)
        ref = backbone[p : p + rl]
        alleles = [ref]
        while len(alleles) < (3 if tri[s] else 2):
            if is_snp[s]:
                alt = _random_seq(rng, 1)
            else:
                alt = _random_seq(rng, int(rng.integers(0, 11)))
            if alt not in alleles:
                alleles.append(alt)
        site_walks = _assign_walks(rng, len(alleles), n_walks)
        site_alleles = []
        for a in alleles:
            if a:
                segs.append(a)
                site_alleles.append(len(segs) - 1)
            else:
                site_alleles.append(-1)  # deletion: chunk -> chunk
        prev_chunk = chunk
        cur = p + rl
    segs.append(backbone[cur:])
    last = len(segs) - 1
    _link_site(links, paths, site_alleles, site_walks, prev_chunk, last)
    for w in range(n_walks):
        paths[w].append(last)
    return segs, links, paths


def _assign_walks(rng, n_alleles: int, n_walks: int) -> np.ndarray:
    """Allele index per walk; every allele is carried by some walk."""
    af = rng.dirichlet(np.ones(n_alleles))
    choice = rng.choice(n_alleles, size=n_walks, p=af)
    carriers = rng.permutation(n_walks)[:n_alleles]
    choice[carriers] = np.arange(n_alleles)
    return choice


def _link_site(links, paths, alleles, walks, left: int, right: int) -> None:
    for a in alleles:
        if a < 0:
            links.append((left, right))
        else:
            links.append((left, a))
            links.append((a, right))
    for w, a in enumerate(walks.tolist()):
        if alleles[a] >= 0:
            paths[w].append(alleles[a])


def write_gfa(path: str, segs, links, paths) -> None:
    with open(path, "w") as fh:
        fh.write("H\tVN:Z:1.1\n")
        fh.writelines(f"S\t{i + 1}\t{s}\n" for i, s in enumerate(segs))
        fh.writelines(f"L\t{a + 1}\t+\t{b + 1}\t+\t0M\n" for a, b in links)
        for (sample, hap), p in zip(WALKS, paths):
            length = sum(len(segs[v]) for v in p)
            walk = "".join(f">{v + 1}" for v in p)
            fh.write(f"W\t{sample}\t{hap}\tchr6\t0\t{length}\t{walk}\n")


def generate(prefix: str, size: str = "mhc4", seed: int = 7) -> tuple[str, str]:
    """Write ``<prefix>.gfa`` and ``<prefix>.fq``; returns both paths."""
    rng = np.random.default_rng(seed)
    segs, links, paths = make_graph(rng, **SIZES[size])
    gfa, fq = prefix + ".gfa", prefix + ".fq"
    write_gfa(gfa, segs, links, paths)
    names = [f"{s}.{h}" for s, h in WALKS]
    walks = [(n, "".join(segs[v] for v in paths[names.index(n)]))
             for n in READ_WALKS]
    with open(fq, "w") as fh:
        simulate(fh, walks, COVERAGE, READ_LEN, 0.0, rng)
    return gfa, fq


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", choices=sorted(SIZES), default="mhc4")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("-o", "--out", required=True, help="output prefix")
    args = ap.parse_args()
    gfa, fq = generate(args.out, args.size, args.seed)
    print(f"wrote {gfa} and {fq}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
