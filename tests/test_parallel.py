"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _need_devices(n):
    import jax

    if len(jax.devices()) < n:
        pytest.skip(f"need {n} devices")


def test_sharded_sketch_count_matches_host():
    import jax.numpy as jnp

    _need_devices(4)
    from dipgenie_tpu.ops.sketch_jax import encode_reads
    from dipgenie_tpu.parallel.mesh import make_mesh, sharded_sketch_count_step
    from dipgenie_tpu.sketch.minimizers import sketch_sequence

    rng = np.random.default_rng(7)
    k, w = 11, 5
    reads = ["".join(rng.choice(list("ACGT"), 80)) for _ in range(16)]
    # haplotype table: minimizers of a random "haplotype"
    hap = "".join(rng.choice(list("ACGT"), 2000))
    tbl = np.unique(sketch_sequence(hap, k, w).hashes)
    thi = (tbl >> np.uint64(32)).astype(np.uint32)
    tlo = (tbl & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    order = np.lexsort((tlo, thi))
    thi, tlo = thi[order], tlo[order]

    codes, lens, _ = encode_reads(reads, 80)
    mesh = make_mesh(n_dp=4, n_tp=1)
    counts, per_read = sharded_sketch_count_step(
        mesh, jnp.asarray(codes), jnp.asarray(lens),
        jnp.asarray(thi), jnp.asarray(tlo), k, w,
    )
    counts = np.asarray(counts)
    per_read = np.asarray(per_read)

    # host truth: per-window emitted minimizers matched against the table
    tbl64 = (thi.astype(np.uint64) << np.uint64(32)) | tlo.astype(np.uint64)
    exp_counts = np.zeros(len(tbl64), np.int64)
    exp_per_read = np.zeros(len(reads), np.int64)
    for i, s in enumerate(reads):
        m = sketch_sequence(s, k, w)
        for h in m.hashes:
            j = np.searchsorted(tbl64, h)
            if j < len(tbl64) and tbl64[j] == h:
                exp_counts[j] += 1
                exp_per_read[i] += 1
    assert np.array_equal(counts, exp_counts)
    assert np.array_equal(per_read, exp_per_read)


def test_sharded_pipeline_end_to_end_byte_identical(tmp_path):
    """FULL pipeline on the real toy fixture under a 2x4 dp*tp mesh:
    dp-sharded device read sketching + tp-sharded device diploid DP must
    produce the exact same FASTA bytes as the single-device native tier."""
    import io

    _need_devices(8)
    from tests.conftest import ref_fixture
    from dipgenie_tpu.parallel.mesh import make_mesh
    from dipgenie_tpu.solver.pipeline import Pipeline, PipelineConfig

    gfa = ref_fixture("test.gfa")
    reads = ref_fixture("read.fa")

    out_ref = tmp_path / "ref.fa"
    Pipeline(
        gfa, reads, str(out_ref),
        PipelineConfig(k=5, w=3, recombination_limit=4, ploidy=2,
                       verbose=False),
    ).run(out=io.StringIO())

    mesh = make_mesh(n_dp=2, n_tp=4)
    out_sh = tmp_path / "sharded.fa"
    Pipeline(
        gfa, reads, str(out_sh),
        PipelineConfig(k=5, w=3, recombination_limit=4, ploidy=2,
                       verbose=False, dp_backend="jax",
                       sketch_backend="device", mesh=mesh),
    ).run(out=io.StringIO())

    assert out_sh.read_bytes() == out_ref.read_bytes()


def test_sharded_dp_full_forward_bit_equal():
    """tp-sharded DeviceDiploidDP over ALL levels of a random leveled DAG
    equals the unsharded device run and the exact host tier in
    (value, s_het, transitions) — numeric equality, not shapes."""
    _need_devices(8)
    from dipgenie_tpu.ops.diploid_jax import DeviceDiploidDP, plan_transitions
    from dipgenie_tpu.parallel.mesh import make_mesh
    from dipgenie_tpu.solver.diploid import build_color_masks, csr_arrays
    from tests.test_device_kernels import _random_leveled_graph

    rng = np.random.default_rng(3)
    g = _random_leveled_graph(rng, L=14, kmax=6)
    chb = [bool(x) for x in rng.random(8) < 0.4]
    plan = plan_transitions(*csr_arrays(g, chb))
    R = 5
    base = DeviceDiploidDP(plan, R).run()
    mesh = make_mesh(n_dp=1, n_tp=8)
    sharded = DeviceDiploidDP(plan, R, mesh=mesh).run()
    assert sharded[0] == base[0]  # DP value
    assert sharded[1] == base[1]  # s_het
    assert sharded[2] == base[2]  # full backtracked transition list

    from dipgenie_tpu.solver.diploid import _forward_exact

    Hm, Tm = build_color_masks(g, chb)
    exact = _forward_exact(g, R, Hm, Tm)
    assert sharded[0] == exact[0]
    assert sharded[1] == exact[1]
    assert sharded[2] == exact[2]


def test_sharded_read_sketch_matches_host_on_fixture():
    """dp-sharded device read sketch on the committed toy read set equals
    the host scanner hash-for-hash."""
    _need_devices(4)
    from dipgenie_tpu.io.fastx import read_fastx
    from dipgenie_tpu.ops.sketch_jax import sketch_reads_device
    from dipgenie_tpu.parallel.mesh import make_mesh
    from dipgenie_tpu.sketch.minimizers import sketch_sequence

    reads = read_fastx(os.path.join(REPO, "tests", "data", "synth_toy.fq"))
    seqs = [s for _, s in reads]
    mesh = make_mesh(n_dp=4, n_tp=1)
    got = sketch_reads_device(seqs, 17, 7, batch=64, mesh=mesh)
    for s, g in zip(seqs, got):
        exp = np.unique(sketch_sequence(s, 17, 7).hashes)
        assert np.array_equal(g, exp)


def test_dryrun_multichip_entrypoints():
    _need_devices(8)
    sys.path.insert(0, REPO)
    import __graft_entry__ as ge

    fn, args = ge.entry()
    import jax

    out = jax.jit(fn)(*args)
    assert out[0].shape == (7, 8, 8)
    ge.dryrun_multichip(8)


def _mhc4_pipeline(tmp_path):
    """Pipeline over the seeded MHC_4-shaped input, index loaded."""
    from dipgenie_tpu.solver.pipeline import Pipeline, PipelineConfig

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import synth_pangenome

    gfa, fq = synth_pangenome.generate(str(tmp_path / "mhc4"), "mhc4")
    p = Pipeline(gfa, fq, "/dev/null", PipelineConfig(verbose=False))
    p.load()
    return p


@pytest.mark.skipif(
    os.environ.get("RUN_SLOW") != "1",
    reason="set RUN_SLOW=1 for the MHC-scale sharded DP",
)
def test_mhc_scale_sharded_dp_matches_single_device(tmp_path):
    """The full diploid DP of the generated MHC_4-shaped input (R=18)
    under a tp=2 virtual-device mesh: (value, s_het, path) must equal
    the single-device chunked tier and the native C++ tier. tp=2: XLA-CPU
    collective rendezvous aborts after 40 s when participants outnumber
    physical cores at this scale."""
    from dipgenie_tpu import native
    from dipgenie_tpu.ops.diploid_jax import DeviceDiploidDP, plan_transitions
    from dipgenie_tpu.parallel.mesh import make_mesh
    from dipgenie_tpu.solver.diploid import csr_arrays

    _need_devices(2)
    p = _mhc4_pipeline(tmp_path)
    p.compute_anchors()
    g, chb, _ = p.diploid_graph()
    arrs = csr_arrays(g, chb)
    R = 18
    plan = plan_transitions(*arrs)
    sv1, ss1, tr1 = DeviceDiploidDP(plan, R).run()
    assert sv1 == native.diploid_dp(*arrs, R, 4)[0]
    mesh = make_mesh(n_dp=1, n_tp=2)
    sv2, ss2, tr2 = DeviceDiploidDP(plan, R, mesh=mesh).run()
    assert (sv2, ss2) == (sv1, ss1)
    assert tr2 == tr1


@pytest.mark.skipif(
    os.environ.get("RUN_SLOW") != "1",
    reason="set RUN_SLOW=1 for the MHC-scale dp-sharded front end",
)
def test_mhc_scale_dp_sharded_front_end_matches_host(tmp_path):
    """The front end at MHC_4 scale: every read of the generated input
    sketched dp-sharded over a 2-device mesh (device minimizer kernel
    under shard_map), then the full anchor pipeline — the resulting
    anchor occurrence arrays and HOM/HET classification must equal the
    host-backend run exactly (reference semantics
    solver.cpp:415-446, 526-575)."""
    _need_devices(2)
    from dipgenie_tpu.io.fastx import read_fastx
    from dipgenie_tpu.parallel.mesh import make_mesh
    from dipgenie_tpu.solver.anchors import compute_and_classify_anchors

    p = _mhc4_pipeline(tmp_path)
    reads = read_fastx(p.reads_file)

    host = compute_and_classify_anchors(
        p.index, reads, 31, 25, 1.0, verbose=False,
        sketch_backend="host",
    )
    mesh = make_mesh(n_dp=2, n_tp=1)
    dev = compute_and_classify_anchors(
        p.index, reads, 31, 25, 1.0, verbose=False,
        sketch_backend="device", mesh=mesh,
    )
    assert dev.count_sp_r == host.count_sp_r
    assert np.array_equal(dev.sp_hashes, host.sp_hashes)
    assert np.array_equal(dev.occ_sp, host.occ_sp)
    assert np.array_equal(dev.occ_hap, host.occ_hap)
    assert np.array_equal(dev.occ_ptr, host.occ_ptr)
    assert np.array_equal(dev.occ_v, host.occ_v)
    assert dev.homo_bv == host.homo_bv
