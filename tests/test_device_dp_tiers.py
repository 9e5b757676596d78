"""The plain-JAX device DP tiers against the exact tier (CPU backend).

One grid, tier × case: random leveled DAGs (narrow, mixed and wide
levels) checked against solver/diploid._forward_exact, and the committed
real-MHC CSR slices checked against their baked exact-tier oracles. The
contract is (sink value, sink s_het, full transition path), bit for bit
(reference semantics src/approximator.cpp:362-716, tie-break :655-659).
"""

import os

import numpy as np
import pytest

from dipgenie_tpu.solver.diploid import (
    DEVICE_TIERS, _forward_exact, build_color_masks, csr_arrays, device_dp,
)
from tests.test_device_kernels import _random_leveled_graph

DATA = os.path.join(os.path.dirname(__file__), "data")
CSR_KEYS = ("level_ptr", "adj_ptr", "adj_v", "adj_w",
            "hom_ptr", "hom_colors", "het_ptr", "het_colors")

# (seed, levels, max width, R, colours): narrow-only, tiny with low R,
# mixed widths, near 32, flat 24-wide, and wide levels (> 32) that take
# the chunked tier's big-step path and the fused tier's wide buckets.
DAG_CASES = (
    [(s, 12, 5, 5, 8) for s in range(6)]
    + [(100 + s, 8, 3, 2, 6) for s in range(3)]
    + [(200 + s, 16, 16, 5, 10) for s in range(3)]
    + [(300 + s, 10, 30, 4, 12) for s in range(3)]
    + [(600 + s, 14, 24, 5, 8) for s in range(2)]
    + [(400 + s, 10, 40, 4, 8) for s in range(3)]
    + [(500 + s, 14, 36, 6, 9) for s in range(2)]
)
# 40 narrow levels; levels 40-99 with widths up to 51; the first 500
SLICES = ("mhc_slice_csr", "mhc_slice_wide_csr", "mhc_slice500_csr")
CASES = (
    [pytest.param(("dag", c), id=f"dag{c[0]}") for c in DAG_CASES]
    + [pytest.param(("slice", n), id=n) for n in SLICES]
)


def _dag(seed, L, kmax, R, nc):
    rng = np.random.default_rng(seed)
    g = _random_leveled_graph(rng, L=L, kmax=kmax, ncolors=nc)
    chb = [bool(x) for x in rng.random(nc) < 0.4]
    Hm, Tm = build_color_masks(g, chb)
    return csr_arrays(g, chb), R, _forward_exact(g, R, Hm, Tm)


def _slice(name):
    d = np.load(os.path.join(DATA, name + ".npz"))
    want = (int(d["oracle_value"]), int(d["oracle_shet"]),
            [tuple(int(x) for x in row) for row in d["oracle_transitions"]])
    return [d[k] for k in CSR_KEYS], int(d["R"]), want


def _instance(case):
    kind, c = case
    return _dag(*c) if kind == "dag" else _slice(c)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("tier", DEVICE_TIERS)
def test_device_tier_matches_exact_tier(tier, case):
    csr, R, want = _instance(case)
    dp = device_dp(csr, R, tier)
    dp.ship()
    dp.compile()
    sv, ss, tr = dp.run()
    assert (sv, ss) == want[:2]
    assert tr == want[2]


@pytest.mark.parametrize(
    "seed,L,kmax,R,nc",
    [(201, 16, 16, 5, 10), (401, 10, 40, 4, 8), (500, 14, 36, 6, 9)],
)
@pytest.mark.parametrize("tier", DEVICE_TIERS)
def test_device_tier_forward_pass_value(tier, seed, L, kmax, R, nc):
    """measure_passes (warm-up, then passes ended by a fetch of the sink
    value) reports the exact tier's value."""
    csr, R, want = _dag(seed, L, kmax, R, nc)
    walls, value = device_dp(csr, R, tier).measure_passes(1)
    assert value == want[0] and len(walls) == 1 and walls[0] > 0


def test_wide_slice_uses_chunked_big_steps():
    """The wide MHC slice (width 51) exercises the chunked tier's per-shape
    big steps as well as its small-bucket scans."""
    from dipgenie_tpu.ops.diploid_jax import DeviceDiploidDP, plan_transitions

    csr, R, _ = _slice("mhc_slice_wide_csr")
    assert int(np.diff(csr[0]).max()) == 51
    kinds = {op.kind for op in DeviceDiploidDP(plan_transitions(*csr), R).ops}
    assert kinds == {"scan", "big"}


def test_fused_backpointer_buffer_stays_out_of_the_switch():
    """The fused tier's flat backpointer buffer is written by a
    dynamic-update-slice in the scan body, never passed through the
    per-level `lax.switch`: a switch operand is copied at every level,
    which made the forward pass quadratic in the number of levels."""
    import jax

    from dipgenie_tpu.ops.diploid_fused import FusedDiploidDP, plan_fused

    csr, R, _ = _slice("mhc_slice500_csr")
    dp = FusedDiploidDP(plan_fused(*csr, R))
    stacks, xs = dp._ship()
    V0, buf = dp._initial()
    assert len(dp.plan.buckets) > 1
    jaxpr = jax.make_jaxpr(dp._forward_fn())(stacks, xs, V0, buf).jaxpr
    while not any(e.primitive.name == "scan" for e in jaxpr.eqns):
        (jaxpr,) = [e.params["jaxpr"].jaxpr for e in jaxpr.eqns
                    if e.primitive.name in ("jit", "pjit")]
    (scan,) = [e for e in jaxpr.eqns if e.primitive.name == "scan"]
    body = scan.params["jaxpr"].jaxpr
    conds = [e for e in body.eqns if e.primitive.name == "cond"]
    dus = [e for e in body.eqns
           if e.primitive.name == "dynamic_update_slice"]
    assert conds and dus
    for e in conds:
        assert all(v.aval.shape != buf.shape for v in e.invars)
        assert all(v.aval.shape != buf.shape for v in e.outvars)
    assert any(e.invars[0].aval.shape == buf.shape for e in dus)
