"""Routing of the diploid DP by the device present, the device tier's
failure and stage-log behaviour, the compile-cache placement, the seeded
input generator, and chip_smoke.py's refusal to run without a GPU.

All on the CPU: the GPU is stood in for by monkeypatching JAX's default
backend name, which is all the routing reads."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from dipgenie_tpu import cli, native
from dipgenie_tpu.solver import pipeline
from dipgenie_tpu.solver.diploid import AUTO_DEVICE_TIER, DEVICE_TIERS, device_dp
from dipgenie_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
TOY_GFA = os.path.join(DATA, "synth_toy.gfa")
TOY_FQ = os.path.join(DATA, "synth_toy.fq")
TOY_DIP = os.path.join(DATA, "synth_toy.dip.fa")  # exact tier, -p2 -R18


def _toy_cli(tmp_path, *extra):
    out = tmp_path / "out.fa"
    rc = cli.main(["-p", "2", "-R", "18", *extra,
                   "-g", TOY_GFA, "-r", TOY_FQ, "-o", str(out)])
    assert rc == 0
    return out.read_bytes()


@pytest.mark.parametrize(
    "platform,native_ok,want",
    [("gpu", True, AUTO_DEVICE_TIER), ("cpu", True, "native"),
     ("cpu", False, "exact")],
)
def test_auto_routes_by_default_backend(monkeypatch, platform, native_ok,
                                        want):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.setattr(native, "available", lambda: native_ok)
    assert pipeline.resolve_dp_backend("auto") == want


@pytest.mark.parametrize("backend", ["exact", "native", *DEVICE_TIERS])
def test_named_backend_is_kept(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert pipeline.resolve_dp_backend(backend) == backend


def test_parser_rejects_removed_pallas_tier():
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--dp-backend", "pallas"])


def test_auto_on_gpu_runs_device_tier_with_stage_logs(monkeypatch, capsys,
                                                      tmp_path):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    got = _toy_cli(tmp_path)
    err = capsys.readouterr().err
    for stage in ("plan", "ship", "compile", "forward+traceback"):
        assert f"{AUTO_DEVICE_TIER} tier: {stage} in" in err
    with open(TOY_DIP, "rb") as fh:
        assert got == fh.read()


def test_device_tier_failure_raises(monkeypatch, tmp_path):
    """A failing device tier raises; nothing falls back to another tier."""
    from dipgenie_tpu.ops.diploid_jax import DeviceDiploidDP

    def boom(self, verbose=False):
        raise RuntimeError("device tier failed")

    monkeypatch.setattr(DeviceDiploidDP, "run", boom)
    with pytest.raises(RuntimeError, match="device tier failed"):
        _toy_cli(tmp_path, "--dp-backend", "jax")
    assert not (tmp_path / "out.fa").exists()


@pytest.mark.parametrize("tier", DEVICE_TIERS)
def test_device_planner_limit_names_host_tier(tier):
    """A level of width 4096 is past both device planners' limits."""
    width = 4096
    level_ptr = np.array([0, 1, 1 + width, 2 + width], np.int64)
    n = int(level_ptr[-1])
    adj_v = np.concatenate([np.arange(1, 1 + width),
                            np.full(width, 1 + width)]).astype(np.int32)
    # source -> every level-1 vertex -> sink
    adj_ptr = np.concatenate([[0], width + np.arange(width + 1),
                              [2 * width]]).astype(np.int64)
    empty_ptr = np.zeros(n + 1, np.int64)
    csr = (level_ptr, adj_ptr, adj_v, np.zeros(2 * width, np.int8),
           empty_ptr, np.zeros(0, np.int32), empty_ptr, np.zeros(0, np.int32))
    with pytest.raises(ValueError, match="--dp-backend native"):
        device_dp(csr, 2, tier)


@pytest.mark.parametrize("backend", ["exact", "native", *DEVICE_TIERS])
def test_cli_toy_bytes_equal_across_tiers(tmp_path, backend):
    with open(TOY_DIP, "rb") as fh:
        assert _toy_cli(tmp_path, "--dp-backend", backend) == fh.read()


@pytest.fixture
def no_cache_dir():
    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_defaults_to_checkout(monkeypatch, no_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert compile_cache.enable_compile_cache() == want


def test_compile_cache_env_var_is_the_only_cache(monkeypatch, tmp_path,
                                                 no_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX itself reads the variable; the helper sets no other directory
    assert jax.config.jax_compilation_cache_dir is None


@pytest.mark.parametrize("dp_backend", ["native", "fused"])
def test_cli_compile_cache_holds_every_kernel(tmp_path, dp_backend):
    """The CLI places the cache before its first compile, so the device
    sketch kernels, compiled before the DP, are cached too: with the
    native DP they are the run's only JAX compiles."""
    cache = tmp_path / "cache"
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    code = (
        "import sys\n"
        "from dipgenie_tpu.utils import compile_cache\n"
        f"compile_cache.DEFAULT_DIR = {str(cache)!r}\n"
        "from dipgenie_tpu import cli\n"
        "sys.exit(cli.main(sys.argv[1:]))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code, "-p", "2", "-R", "18", "-k", "17",
         "-w", "7", "--sketch-backend", "device", "--dp-backend", dp_backend,
         "-g", TOY_GFA, "-r", TOY_FQ, "-o", str(tmp_path / "out.fa")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.listdir(cache)


def test_native_thread_count():
    assert native.available()
    assert 1 <= native.max_threads() <= os.cpu_count()


def _synth():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import synth_pangenome

    return synth_pangenome


def test_generator_is_deterministic(tmp_path):
    """The same seed gives the same bytes, those of the committed toy."""
    synth = _synth()
    a = synth.generate(str(tmp_path / "a"), "toy", seed=7)
    b = synth.generate(str(tmp_path / "b"), "toy", seed=7)
    for pa, pb, committed in zip(a, b, (TOY_GFA, TOY_FQ)):
        with open(pa, "rb") as fa, open(pb, "rb") as fb, \
                open(committed, "rb") as fc:
            data = fa.read()
            assert data == fb.read() == fc.read()
    c = synth.generate(str(tmp_path / "c"), "toy", seed=8)
    with open(c[0], "rb") as fh, open(TOY_GFA, "rb") as fc:
        assert fh.read() != fc.read()


def test_generator_graph_is_consistent():
    """Every segment lies on a walk, and every read is a substring of one
    of the two sampled walks (or of its reverse complement)."""
    from dipgenie_tpu.graph.pangenome import PangenomeIndex
    from dipgenie_tpu.io.fastx import read_fastx
    from dipgenie_tpu.io.gfa import read_gfa

    synth = _synth()
    index = PangenomeIndex.from_gfa(read_gfa(TOY_GFA))
    assert index.hap_id2name == [f"{s}.{h}" for s, h in synth.WALKS]
    assert index.in_paths.any(axis=0).all()
    walks = [index.haplotype_seq(index.hap_id2name.index(n))
             for n in synth.READ_WALKS]
    comp = str.maketrans("ACGT", "TGCA")
    for _, seq in read_fastx(TOY_FQ):
        rc = seq.translate(comp)[::-1]
        assert any(seq in w or rc in w for w in walks)


def test_chip_smoke_fails_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, cwd=tmp_path,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def _chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def test_chip_smoke_phases_on_cpu_toy(monkeypatch, tmp_path, capsys):
    """chip_smoke's phases 2-7 at the toy size, with the CPU standing in
    for the GPU (the slices of phase 8 are cases of
    tests/test_device_dp_tiers.py). The trace of phase 5 runs but finds
    no GPU plane on the CPU. k=17 keeps the CPU compile of the device
    sketch short."""
    chip_smoke = _chip_smoke()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    smoke = chip_smoke.Smoke(str(tmp_path), "cpu", size="toy", k=17, w=7)
    smoke.phase_input()
    smoke.phase_native()
    smoke.phase_gpu()
    walls = smoke.phase_tier_walls()
    with pytest.raises(RuntimeError, match="no GPU stream events"):
        smoke.phase_trace(str(tmp_path / "trace"))
    assert list((tmp_path / "trace" / DEVICE_TIERS[0]).rglob("*.xplane.pb"))
    smoke.phase_sketch()
    smoke.phase_fitter()
    assert set(walls) >= set(DEVICE_TIERS)
    out = capsys.readouterr().out
    assert f"auto -> {AUTO_DEVICE_TIER}" in out
    assert "device sketches equal the host scanner's" in out


def test_chip_smoke_trace_stats():
    """Kernels and copies are counted apart; idle share is the part of
    the window that no event covers."""
    events = [("fusion_1", 0, 10), ("MemcpyD2H", 12, 14),
              ("fusion_2", 13, 20), ("MemcpyD2D", 30, 40),
              ("loop_add", 31, 33)]
    st = _chip_smoke().trace_stats(events, 2)
    assert st["kernels"] == 1.5
    assert st["copies"] == 1.0
    assert st["d2h"] == 0.5
    assert st["idle"] == pytest.approx(1 - 28 / 40)
    assert st["window_ms"] == pytest.approx(40e-6)
    assert st["top"][0] == ("fusion_1", 1)
    with pytest.raises(RuntimeError, match="no GPU stream events"):
        _chip_smoke().trace_stats([], 2)
