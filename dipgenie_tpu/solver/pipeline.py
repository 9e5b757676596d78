"""End-to-end inference pipeline orchestration.

Equivalent of main() + Approximator::solve
(reference: src/main.cpp:24-209, src/approximator.cpp:1014-1331):
load GFA → build index → read reads → anchors/classification →
expanded graph → haploid or diploid DP → FASTA output.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

from ..graph.expanded import build_expanded_graph
from ..graph.pangenome import PangenomeIndex
from ..io.fasta import write_fasta
from ..io.fastx import read_fastx
from ..io.gfa import read_gfa
from ..solver.anchors import AnchorData, compute_and_classify_anchors
from ..solver.diploid import AUTO_DEVICE_TIER, diploid_dp_solver
from ..solver.haploid import dp_approximation_solver
from ..utils.timing import log_stage


def resolve_dp_backend(backend: str) -> str:
    """``auto`` runs the diploid DP on the device tier when JAX's default
    backend is an accelerator, and on the native C++ tier (the exact
    numpy tier without it) on the CPU. Other names pass through."""
    if backend != "auto":
        return backend
    import jax

    if jax.default_backend() != "cpu":
        return AUTO_DEVICE_TIER
    from .. import native

    return "native" if native.available() else "exact"


def get_hap_name(gfa_name: str, reads_name: str) -> str:
    """Reference filename munging (misc.cpp:73-101)."""
    hap_name = os.path.basename(gfa_name)
    dot = hap_name.rfind(".")
    if dot != -1:
        hap_name = hap_name[:dot]
    hap_name += "_" + os.path.basename(reads_name)
    dot = hap_name.rfind(".")
    if dot != -1:
        hap_name = hap_name[:dot]
    return hap_name


@dataclass
class PipelineConfig:
    k: int = 31  # options.cpp:7
    w: int = 25  # options.cpp:8
    recombination_limit: int = 18  # main.cpp:44
    recombination_penalty: int = 100  # main.cpp:45
    ploidy: int = 2  # main.cpp:50
    threshold: float = 1.0  # main.cpp:48
    num_threads: int = 4
    debug: bool = False
    verbose: bool = True
    progress: bool = False
    dp_backend: str = "auto"  # auto | exact | native | jax | fused
    sketch_backend: str = "host"  # host | device
    # optional jax.sharding.Mesh ("dp" x "tp"): reads shard over dp for
    # device sketching; the chunked DP tier's state tiles over tp
    mesh: object = None
    # optional checkpoint directory: the anchor stage (sketch + join +
    # classify) resumes from disk on rerun (utils/checkpoint.py)
    checkpoint_dir: str | None = None


class Pipeline:
    def __init__(self, gfa_file: str, reads_file: str, hap_file: str,
                 cfg: PipelineConfig | None = None):
        self.gfa_file = gfa_file
        self.reads_file = reads_file
        self.hap_file = hap_file
        self.cfg = cfg or PipelineConfig()
        self.hap_name = get_hap_name(gfa_file, reads_file)
        self.index: PangenomeIndex | None = None
        self.anchors: AnchorData | None = None

    def load(self) -> None:
        g = read_gfa(self.gfa_file)
        if self.cfg.verbose:
            log_stage("main", f"Loaded graph from: {self.gfa_file}")
        self.index = PangenomeIndex.from_gfa(g)

    def run(self, out=None) -> None:
        out = sys.stdout if out is None else out
        self.compute_anchors()
        self.solve(diploid=(self.cfg.ploidy == 2), out=out)

    def compute_anchors(self) -> None:
        """Sketch, join and classify (resuming from a checkpoint if set)."""
        cfg = self.cfg
        if self.index is None:
            self.load()
        ck_key = None
        anchors = None
        if cfg.checkpoint_dir:
            from ..utils import checkpoint as _ckpt

            ck_key = _ckpt.anchors_key(
                self.gfa_file, self.reads_file, cfg.k, cfg.w, cfg.threshold
            )
            anchors = _ckpt.load_anchors(cfg.checkpoint_dir, ck_key)
            if anchors is not None and cfg.verbose:
                log_stage(
                    "main",
                    f"Resumed anchors from checkpoint {ck_key}",
                )
        if anchors is None:
            reads = read_fastx(self.reads_file)
            anchors = compute_and_classify_anchors(
                self.index, reads, cfg.k, cfg.w, cfg.threshold,
                verbose=cfg.verbose,
                sketch_backend=cfg.sketch_backend, mesh=cfg.mesh,
            )
            if ck_key is not None:
                from ..utils import checkpoint as _ckpt

                _ckpt.save_anchors(cfg.checkpoint_dir, ck_key, anchors)
        self.anchors = anchors

    def solve(self, diploid: bool, out=None) -> None:
        out = sys.stdout if out is None else out
        cfg = self.cfg
        from .. import native as _native

        backend = resolve_dp_backend(cfg.dp_backend)
        use_native_build = _native.available() and backend != "exact"
        if not diploid:
            g, _ = self._expanded_graph(use_native_build)
            dp_path = dp_approximation_solver(g, cfg.recombination_limit, out=out)
            dp_output = "".join(self.index.node_seq[u] for u in dp_path)
            write_fasta(self.hap_file, [(f"dp_sol LN:{len(dp_output)}", dp_output)])
        else:
            g, color_homo_bv, build = self.diploid_graph(use_native_build)
            solutions = diploid_dp_solver(
                g, cfg.recombination_limit, color_homo_bv,
                build.anchors_by_hap, self.index, out=out,
                progress=cfg.progress, backend=backend,
                n_threads=cfg.num_threads, mesh=cfg.mesh,
            )
            for r1, r2, s1, s2 in solutions:
                print(
                    f"recombinations in P1: {r1}, recombinations in P2: {r2}"
                    f", bp of P1: {len(s1)}, bp of P2: {len(s2)}",
                    file=out,
                )
            if len(solutions) == 1:
                r1, r2, s1, s2 = solutions[0]
                write_fasta(
                    self.hap_file,
                    [(f"sol_1 bp:{len(s1)}", s1), (f"sol_2 bp:{len(s2)}", s2)],
                )
            else:
                print("No solution reported, output file not written.", file=out)
        print(f"Diploid sequences written to: {self.hap_file}", file=out)

    def _expanded_graph(self, use_native_build: bool):
        """Expanded graph, Kahn-reordered, and its build record."""
        if use_native_build:
            from ..graph.expanded import build_expanded_graph_native

            build = build_expanded_graph_native(self.index, self.anchors)
            return build.graph, build
        if self.anchors.occ_sp is not None and not self.anchors.anchor_hits:
            from ..solver.anchors import materialize_hits

            self.anchors.anchor_hits = materialize_hits(
                self.anchors, self.index.num_walks
            )
        build = build_expanded_graph(self.index, self.anchors)
        build.graph.topologically_reorder(build.sink)
        return build.graph, build

    def diploid_graph(self, use_native_build: bool = True):
        """Levelized expanded graph, per-colour HOM flags and build record
        for the diploid DP (after compute_anchors)."""
        g, build = self._expanded_graph(use_native_build)
        color_homo_bv = [
            bool(self.anchors.homo_bv[build.color_to_anchor[c]])
            for c in range(build.num_colors)
        ]
        if use_native_build:
            # C++ levelizer + CSR view (no Python list rebuild)
            from ..graph.leveled import levelize_native

            g = levelize_native(g)
        else:
            g.strict_bfs_levelize_and_reorder()
        return g, color_homo_bv, build
