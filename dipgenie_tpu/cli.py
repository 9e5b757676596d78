"""Command-line driver with the reference's flag surface.

Mirrors main() (reference: src/main.cpp:24-209), including the quirky
``-a`` semantics: ``-a`` is documented as "DP approximation mode"
(main.cpp:93) but the *default* (-a0) runs the DP Approximator and
``-a1`` selects the ILP branch, which is a no-op unless an ILP backend
is available (main.cpp:130, 167-199; the stock reference Makefile never
defines -DILP). We reproduce that behavior and print a note.

Extra flags beyond the reference (prefixed ``--``): --dp-backend,
--sketch-backend, --progress.

Parsed-but-unused flags, for parity — each is equally dead in the
reference binary:
  -H (top_k): stored at main.cpp:153 but no downstream read;
  -c (max_occ): stored at main.cpp:152, never read after;
  -N (naive expanded graph): stored at main.cpp:176, never read;
  -l (low coverage): stored at main.cpp:178, never read (ROADMAP #8).
"""

from __future__ import annotations

import argparse
import sys

from . import PHI_VERSION
from .solver.pipeline import Pipeline, PipelineConfig
from .utils import timing
from .utils.compile_cache import enable_compile_cache


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="dipgenie-tpu",
        usage="dipgenie-tpu -g <target.gfa> -r <reads.fa> -o <haplotype.fasta>",
        add_help=False,
    )
    ap.add_argument("-a", type=int, default=0, help="DP approximation mode")
    ap.add_argument("-k", type=int, default=31, help="K-mer size [31]")
    ap.add_argument("-w", type=int, default=25, help="Minimizer window size [25]")
    ap.add_argument("-R", type=int, default=18, help="Recombination limit [18]")
    ap.add_argument("-P", type=int, default=100,
                    help="Recombination penality for ILP [100]")
    ap.add_argument("-H", dest="top_k", type=int, default=15,
                    help="Top H haplotypes [15]")
    ap.add_argument("-q", type=int, default=1,
                    help="Mode QP/ILP (default IQP i.e q1, use q0 for ILP) [1]")
    ap.add_argument("-N", type=int, default=0, help="Naive expanded graph mode")
    ap.add_argument("-m", type=int, default=1,
                    help="Mixed/Integer programming (default Mixed -m1) [1]")
    ap.add_argument("-p", type=int, default=2,
                    help="Ploidy (default diploid -p2, -p1 for haploid) [2]")
    ap.add_argument("-l", type=int, default=0, help="Low coverage mode [0]")
    ap.add_argument("-T", type=float, default=1.0,
                    help="Threshold for minimizer filtering [1.000]")
    ap.add_argument("-t", type=int, default=4, help="Threads [4]")
    ap.add_argument("-g", type=str, default="", help="GFA file")
    ap.add_argument("-r", type=str, default="", help="Read file")
    ap.add_argument("-o", type=str, default="", help="Output haplotype file")
    ap.add_argument("-c", type=int, default=5000, help="Max k-mer occurrence")
    ap.add_argument("-d", type=int, default=0, help="Debug mode [0]")
    ap.add_argument("-h", action="store_true", help="Show help")
    ap.add_argument("--version", action="store_true")
    ap.add_argument("--dp-backend", type=str, default="auto",
                    choices=["auto", "exact", "native", "jax", "fused"],
                    help="diploid DP tier; auto runs the device tier on an "
                         "accelerator and native C++ on the CPU")
    ap.add_argument("--sketch-backend", type=str, default="host",
                    choices=["host", "device"])
    ap.add_argument("--progress", action="store_true")
    ap.add_argument("--checkpoint-dir", type=str, default="",
                    help="Resume the anchor stage from DIR on rerun")
    return ap


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.version:
        print(f"PHI version: {PHI_VERSION}", file=sys.stderr)
        return 0

    if not argv or not args.g or not args.r or not args.o or args.h:
        ap.print_help(sys.stderr)
        return 0 if args.h else 1

    timing.set_start()
    if args.dp_backend not in ("exact", "native") or \
            args.sketch_backend == "device":
        # before the run's first compile: JAX settles on its persistent
        # cache there
        enable_compile_cache()

    if args.a:
        # -a1 selects the ILP branch (main.cpp:167-199). The stock reference
        # build compiles it out (no -DILP / Gurobi); here it is a real exact
        # solver (HiGHS branch-and-bound, solver/ilp.py).
        print(
            "[M::main] -a1: exact ILP solver (HiGHS); note the stock "
            "reference build compiles this branch out.",
            file=sys.stderr,
        )
        from .io.fastx import read_fastx
        from .solver.anchors import compute_and_classify_anchors
        from .solver.ilp import ilp_solve
        from .solver.pipeline import get_hap_name

        cfg = PipelineConfig(
            k=args.k, w=args.w, recombination_penalty=args.P, ploidy=args.p,
            threshold=args.T, num_threads=args.t, debug=bool(args.d),
            sketch_backend=args.sketch_backend,
        )
        pipe = Pipeline(args.g, args.r, args.o, cfg)
        pipe.load()
        reads = read_fastx(args.r)
        anchors = compute_and_classify_anchors(
            pipe.index, reads, cfg.k, cfg.w, cfg.threshold,
            sketch_backend=cfg.sketch_backend,
        )
        ilp_solve(
            pipe.index, anchors, args.o, get_hap_name(args.g, args.r),
            ploidy=args.p, recombination_penalty=args.P,
            is_mixed=bool(args.m),
        )
    else:
        if args.p not in (1, 2):
            print("Current approximator support is only for ploidy = 1 or ploidy = 2")
            return 0
        cfg = PipelineConfig(
            k=args.k, w=args.w, recombination_limit=args.R,
            recombination_penalty=args.P, ploidy=args.p, threshold=args.T,
            num_threads=args.t, debug=bool(args.d), progress=args.progress,
            dp_backend=args.dp_backend, sketch_backend=args.sketch_backend,
            checkpoint_dir=args.checkpoint_dir or None,
        )
        Pipeline(args.g, args.r, args.o, cfg).run()

    print(f"[M::main] PHI Version: {PHI_VERSION}", file=sys.stderr)
    print("[M::main] CMD: dipgenie-tpu " + " ".join(argv), file=sys.stderr)
    rt = timing.realtime()
    print(
        f"[M::main] Real time: {rt:.3f} sec; CPU: {timing.cputime():.3f} sec; "
        f"Peak RSS: {timing.peakrss_bytes() / 1024**3:.3f} GB",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
