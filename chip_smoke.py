#!/usr/bin/env python3
"""Smoke run of the diploid pipeline on one NVIDIA GPU at MHC_4 scale.

One process, one card. Phases, in order; any failure exits non-zero:

1. device: JAX's first device must be a GPU; prints the card's name and
   power limit (nvidia-smi), its device kind and the JAX version;
2. input: an MHC_4-shaped graph and read set from
   scripts/synth_pangenome.py (seeded);
3. native: the CLI, ``-p2 -R18 --dp-backend native``; the levelized
   graph must hold at least 1e8 DP states at R=18;
4. gpu: the CLI with ``--dp-backend auto``, which must resolve to the
   device tier and give the native run's FASTA bytes and DP value;
5. tier walls: forward passes of both plain-JAX device tiers (warm-up,
   then a pass ended by a fetch of the sink value) and of the native
   C++ tier, on phase 4's levelized graph; then a jax.profiler trace of
   each device tier over a 2,000-level cut of that graph, reduced to
   kernels and copies per level and the device's idle share;
6. sketch parity: device read sketches equal the host scanner's;
7. fitter parity: the jax grid fitter gives the numpy fitter's
   parameters on the generated histogram;
8. committed slices: tests/data's real-MHC CSR slices through both
   device tiers equal their exact-tier oracles (value, s_het, path).

The last line of standard output is the JSON object
``{"ok": true, "device": {...}}``. Usage:

  python chip_smoke.py
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
R = 18
MIN_STATES = 10**8
SLICES = ("mhc_slice_csr", "mhc_slice_wide_csr", "mhc_slice500_csr")
CSR_KEYS = ("level_ptr", "adj_ptr", "adj_v", "adj_w",
            "hom_ptr", "hom_colors", "het_ptr", "het_colors")
TRACE_LEVELS = 2000


def say(msg: str) -> None:
    print(msg, flush=True)


def card_label() -> str:
    """`name, power.limit` of the first card, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


@contextlib.contextmanager
def captured_csr(store: dict):
    """Keep the levelized CSR arrays the diploid solver builds."""
    from dipgenie_tpu.solver import diploid

    orig = diploid.csr_arrays

    def keep(g, color_homo_bv):
        store["csr"] = orig(g, color_homo_bv)
        return store["csr"]

    diploid.csr_arrays = keep
    try:
        yield
    finally:
        diploid.csr_arrays = orig


def dp_states(level_ptr) -> tuple[int, int, int]:
    """(levels, widest level, DP states (R+1)·Σ width²)."""
    w = np.diff(np.asarray(level_ptr, np.int64))
    return len(w), int(w.max()), (R + 1) * int((w * w).sum())


class Smoke:
    """The phases after the device check; ``label`` tags every timing."""

    def __init__(self, workdir: str, label: str, size: str = "mhc4",
                 k: int = 31, w: int = 25):
        self.workdir = workdir
        self.label = label
        self.size = size
        self.k, self.w = k, w  # sketch parameters of phases 6-7

    def timing(self, what: str, secs: float) -> None:
        say(f"{what}: {secs:.3f} s [{self.label}]")

    def run_cli(self, backend: str):
        from dipgenie_tpu import cli

        out_fa = os.path.join(self.workdir, f"{backend}.fa")
        args = ["-p", "2", "-R", str(R), "--dp-backend", backend,
                "-g", self.gfa, "-r", self.fq, "-o", out_fa]
        stdout, stderr, store = io.StringIO(), io.StringIO(), {}
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(_Tee(sys.stderr, stderr)), \
                captured_csr(store):
            rc = cli.main(args)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"CLI --dp-backend {backend} exited {rc}")
        m = re.search(r"^DP value: (-?\d+)$", stdout.getvalue(), re.M)
        with open(out_fa, "rb") as fh:
            fasta = fh.read()
        return int(m.group(1)), fasta, wall, stderr.getvalue(), store["csr"]

    def phase_input(self) -> None:
        sys.path.insert(0, os.path.join(REPO, "scripts"))
        import synth_pangenome

        t0 = time.perf_counter()
        self.gfa, self.fq = synth_pangenome.generate(
            os.path.join(self.workdir, self.size), self.size)
        wall = time.perf_counter() - t0
        with open(self.gfa) as fh:
            tags = [line[0] for line in fh]
        with open(self.fq) as fh:
            n_reads = sum(1 for _ in fh) // 4
        say(f"[input] {self.size}: {tags.count('S')} segments, "
            f"{tags.count('L')} links, {tags.count('W')} walks, "
            f"{n_reads} reads")
        self.timing("[input] generate", wall)

    def phase_native(self) -> None:
        from dipgenie_tpu import native

        if not native.available():
            raise RuntimeError("the native runtime did not build (see above)")
        self.value, self.fasta, wall, _, csr = self.run_cli("native")
        levels, widest, states = dp_states(csr[0])
        say(f"[native] DP value {self.value}; {levels} levels, widest "
            f"{widest}, {states} DP states at R={R}")
        self.timing("[native] CLI wall", wall)
        if self.size == "mhc4" and states < MIN_STATES:
            raise RuntimeError(f"{states} DP states < {MIN_STATES}")

    def phase_gpu(self) -> None:
        from dipgenie_tpu.solver.diploid import AUTO_DEVICE_TIER
        from dipgenie_tpu.solver.pipeline import resolve_dp_backend

        tier = resolve_dp_backend("auto")
        if tier != AUTO_DEVICE_TIER:
            raise RuntimeError(f"auto resolved to {tier}, not the device tier")
        value, fasta, wall, err, self.csr = self.run_cli("auto")
        stages = re.findall(rf"\] ({tier} tier: .*)$", err, re.M)
        if len(stages) != 4:
            raise RuntimeError(f"device tier stage log missing: {stages}")
        for line in stages:
            say(f"[gpu] {line} [{self.label}]")
        if value != self.value or fasta != self.fasta:
            raise RuntimeError(
                f"auto ({tier}) DP value {value} / FASTA differ from native "
                f"({self.value})")
        say(f"[gpu] auto -> {tier}: DP value {value}, FASTA bytes equal "
            "to native")
        self.timing("[gpu] CLI wall", wall)

    def phase_tier_walls(self) -> dict:
        from dipgenie_tpu import native
        from dipgenie_tpu.solver.diploid import DEVICE_TIERS, device_dp

        walls = {}
        for tier in DEVICE_TIERS:
            t0 = time.perf_counter()
            dp = device_dp(self.csr, R, tier)
            dp.ship()
            dp.compile()
            setup = time.perf_counter() - t0
            passes, value = dp.measure_passes(1)
            del dp
            if value != self.value:
                raise RuntimeError(f"{tier} forward value {value} != "
                                   f"{self.value}")
            walls[tier] = passes[0]
            self.timing(f"[walls] {tier} plan+ship+compile", setup)
            self.timing(f"[walls] {tier} forward", passes[0])
        most = native.max_threads()
        say(f"[walls] native tier: {most} thread(s) available")
        for threads in sorted({min(4, most), most}):
            t0 = time.perf_counter()
            value = native.diploid_dp(*self.csr, R, threads)[0]
            wall = time.perf_counter() - t0
            if value != self.value:
                raise RuntimeError(f"native value {value} != {self.value}")
            walls[f"native-t{threads}"] = wall
            self.timing(f"[walls] native forward+traceback, {threads} "
                        "thread(s)", wall)
        say(f"[walls] fastest plain tier: {min(DEVICE_TIERS, key=walls.get)}")
        return walls

    def phase_sketch(self) -> None:
        from dipgenie_tpu import native
        from dipgenie_tpu.io.fastx import read_fastx
        from dipgenie_tpu.ops.sketch_jax import sketch_reads_device

        seqs = [s for _, s in read_fastx(self.fq)]
        t0 = time.perf_counter()
        dev = sketch_reads_device(seqs, self.k, self.w)
        wall = time.perf_counter() - t0
        host = native.sketch_batch([s.encode() for s in seqs], self.k, self.w)
        for i, (d, h) in enumerate(zip(dev, host)):
            if not np.array_equal(d, np.unique(h)):
                raise RuntimeError(f"device sketch differs on read {i}")
        self.read_hashes = dev
        say(f"[sketch] {len(seqs)} reads: device sketches equal the host "
            "scanner's")
        self.timing("[sketch] device sketch incl. compile", wall)

    def phase_fitter(self) -> None:
        from dipgenie_tpu.models.fitter import fit_histogram
        from dipgenie_tpu.solver.anchors import multiplicity_histogram

        sp = np.unique(np.concatenate(self.read_hashes))
        _, hist, opt = multiplicity_histogram(self.read_hashes, sp)
        ref = fit_histogram(hist, opt, backend="numpy")
        t0 = time.perf_counter()
        got = fit_histogram(hist, opt, backend="jax")
        wall = time.perf_counter() - t0
        if got.P != ref.P or got.nll != ref.nll:
            raise RuntimeError(f"jax fit {got} != numpy fit {ref}")
        say(f"[fitter] jax grid fit equals numpy: {got.P}")
        self.timing("[fitter] jax fit incl. compile", wall)

    def phase_slices(self) -> None:
        from dipgenie_tpu.solver.diploid import DEVICE_TIERS, device_dp

        for name in SLICES:
            d = np.load(os.path.join(REPO, "tests", "data", name + ".npz"))
            want = (int(d["oracle_value"]), int(d["oracle_shet"]),
                    [tuple(int(x) for x in row)
                     for row in d["oracle_transitions"]])
            for tier in DEVICE_TIERS:
                dp = device_dp([d[k] for k in CSR_KEYS], int(d["R"]), tier)
                dp.ship()
                dp.compile()
                sv, ss, tr = dp.run()
                if (sv, ss, tr) != want:
                    raise RuntimeError(f"{name} via {tier}: ({sv}, {ss}) vs "
                                       f"oracle {want[:2]}")
            say(f"[slices] {name}: value {want[0]}, s_het {want[1]} and "
                f"the full path equal the oracle in {', '.join(DEVICE_TIERS)}")

    def phase_trace(self, logdir: str) -> None:
        """Profile each device tier's forward pass on a cut of the graph."""
        import glob

        import jax

        sys.path.insert(0, os.path.join(REPO, "scripts"))
        from make_mhc_slice import slice_csr

        from dipgenie_tpu.solver.diploid import DEVICE_TIERS, device_dp

        n = min(TRACE_LEVELS, len(self.csr[0]) - 2)
        cut, _ = slice_csr(self.csr, n, 1)
        for tier in DEVICE_TIERS:
            dp = device_dp(cut, R, tier)
            dp.ship()
            dp.compile()
            dp.measure_passes(1)
            tdir = os.path.join(logdir, tier)
            with jax.profiler.trace(tdir):
                dp.measure_passes(1)  # its warm-up and its timed pass
            path = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                                    recursive=True))[-1]
            st = trace_stats(gpu_stream_events(path), TRACED_PASSES * n)
            say(f"[trace] {tier}, {n}-level cut: {st['kernels']:.1f} kernels "
                f"and {st['d2h']:.2f} device-to-host copies per level, "
                f"{st['copies']:.2f} copies in all; idle share "
                f"{st['idle']:.3f} of {st['window_ms']:.3f} ms [{self.label}]")
            say(f"[trace] {tier} most frequent: {st['top']}")


TRACED_PASSES = 2  # measure_passes(1) runs a warm-up pass and a timed one


def gpu_stream_events(path: str) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every event on the stream lines of the
    GPU planes of a jax.profiler ``.xplane.pb``."""
    from jax.profiler import ProfileData

    return [(e.name, e.start_ns, e.start_ns + e.duration_ns)
            for plane in ProfileData.from_file(path).planes
            if plane.name.startswith("/device:GPU")
            for line in plane.lines if line.name.startswith("Stream")
            for e in line.events]


def trace_stats(events, n_levels: int) -> dict:
    """Kernels and copies per level, and the device's idle share.

    An event named ``Memcpy*`` or ``Memset*`` is a copy, any other is a
    kernel. Busy time is the union of all event intervals; the window runs
    from the first start to the last end."""
    if not events:
        raise RuntimeError("the trace holds no GPU stream events")
    names: dict[str, int] = {}
    for name, _, _ in events:
        names[name] = names.get(name, 0) + 1
    n_copies = sum(c for k, c in names.items()
                   if k.startswith(("Memcpy", "Memset")))
    n_d2h = sum(c for k, c in names.items() if k.startswith("MemcpyD2H"))
    spans = sorted((s, e) for _, s, e in events)
    busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = cur_e - spans[0][0]
    return {
        "kernels": (len(events) - n_copies) / n_levels,
        "copies": n_copies / n_levels,
        "d2h": n_d2h / n_levels,
        "idle": 1 - busy / window,
        "window_ms": window / 1e6,
        "top": sorted(names.items(), key=lambda kv: -kv[1])[:8],
    }


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's first device is {dev.platform})",
              file=sys.stderr)
        return 1
    label = card_label()
    say(f"[device] {label}")
    say(f"[device] {dev.device_kind}, {len(jax.devices())} device(s), "
        f"jax {jax.__version__}")

    from dipgenie_tpu.utils.compile_cache import enable_compile_cache

    say(f"[device] compile cache: {enable_compile_cache()}")
    with tempfile.TemporaryDirectory() as work:
        smoke = Smoke(work, label)
        smoke.phase_input()
        smoke.phase_native()
        smoke.phase_gpu()
        smoke.phase_tier_walls()
        smoke.phase_trace(os.path.join(work, "trace"))
        smoke.phase_sketch()
        smoke.phase_fitter()
        smoke.phase_slices()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
