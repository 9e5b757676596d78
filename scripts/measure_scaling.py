#!/usr/bin/env python
"""Measure tp-sharded diploid-DP forward scaling (1 vs N devices).

Runs the full DeviceDiploidDP forward on a wide synthetic leveled
workload, unsharded and tp-sharded, and prints one JSON line per
configuration. On the virtual CPU mesh (JAX_PLATFORMS=cpu with
--xla_force_host_platform_device_count=N) the numbers validate the
mechanism and the collective layout, not real speedup: virtual devices
share the host's cores.

Usage: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python scripts/measure_scaling.py [--levels 96] [--width 160] [--R 18]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402



def synthetic_plan(L: int, B: int, P: int, W: int, seed: int = 0):
    from dipgenie_tpu.ops.diploid_jax import Transition

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(L):
        pi = rng.integers(0, B, (B, P)).astype(np.int32)
        pw = (rng.random((B, P)) < 0.2).astype(np.int32)
        pm = np.ones((B, P), bool)
        mk = lambda: rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(
            np.uint32
        )
        out.append(Transition(B, B, pi, pw, pm, mk(), mk(), mk(), mk()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--levels", type=int, default=96)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--pred", type=int, default=8)
    ap.add_argument("--words", type=int, default=8)
    ap.add_argument("--R", type=int, default=18)
    ap.add_argument("--passes", type=int, default=2)
    args = ap.parse_args()

    import jax

    from dipgenie_tpu.ops.diploid_jax import DeviceDiploidDP
    from dipgenie_tpu.parallel.mesh import make_mesh

    n = len(jax.devices())
    plan = synthetic_plan(args.levels, args.width, args.pred, args.words)
    states = args.levels * (args.R + 1) * args.width * args.width

    for tp in [1, n]:
        mesh = make_mesh(n_dp=1, n_tp=tp) if tp > 1 else None
        dp = DeviceDiploidDP(plan, args.R, mesh=mesh)
        secs = min(dp.measure_passes(passes=args.passes)[0])
        print(json.dumps({
            "metric": "dp_forward_states_per_s",
            "tp": tp,
            "devices": n,
            "platform": jax.devices()[0].platform,
            "levels": args.levels,
            "width": args.width,
            "R": args.R,
            "value": states / secs,
            "seconds": secs,
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
