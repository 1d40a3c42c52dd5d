"""Per-phase breakdown of the dense-pair cost (the bench.py workload).

Times, for the warm 35k bunny pair: host grid build, pool host plan,
demand estimate, device prepack (seed upload + _build_pools dispatch +
settle), and the align loop — the decomposition round-5 item #3 (cut the
per-pair ctor cost) optimizes against.

Usage: python benchmarks/probe_ctor.py [--points 35000] [--iters 15]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from common import emit


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=35_000)
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--fixture", default="bunny", choices=["bunny", "kitti"])
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from probabilistic_point_clouds_registration_tpu.core.params import (
        RegistrationParams,
    )
    from probabilistic_point_clouds_registration_tpu.core.types import (
        pad_cloud,
    )
    from probabilistic_point_clouds_registration_tpu.io.synthetic import (
        bunny_like,
    )
    from probabilistic_point_clouds_registration_tpu.models.registration import (
        ProbabilisticRegistration,
    )
    from probabilistic_point_clouds_registration_tpu.ops import (
        fused_pool as fp,
    )
    from probabilistic_point_clouds_registration_tpu.ops.grid import (
        build_grid_host,
    )
    from probabilistic_point_clouds_registration_tpu.utils.compile_cache import (
        enable_persistent_compilation_cache,
    )

    enable_persistent_compilation_cache()

    if args.fixture == "kitti":
        from probabilistic_point_clouds_registration_tpu.io.synthetic import (
            kitti_like,
        )

        tgt = kitti_like(args.points)
        radius, pad, shift = 0.5, 4096, np.array([0.8, 0.1, 0.02])
    else:
        tgt = bunny_like(args.points)
        radius, pad, shift = 0.075, 1024, np.array([0.02, -0.015, 0.01])
    theta = 0.02 if args.fixture == "bunny" else 0.01
    rot = np.array(
        [
            [np.cos(theta), -np.sin(theta), 0.0],
            [np.sin(theta), np.cos(theta), 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    src = tgt @ rot.T + shift
    params = RegistrationParams(
        max_neighbours=20, dof=5.0, radius=radius, n_iter=args.iters,
        cost_drop_thresh=-1.0, dtype="float32", pad_multiple=pad,
        max_inner_iterations=50, outer_chunk=args.iters,
    )

    def one_pair():
        t = {}
        t0 = time.perf_counter()
        reg = ProbabilisticRegistration(src, tgt, params)
        t["ctor"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        reg.align()
        t["align"] = time.perf_counter() - t0
        return t

    one_pair()  # compile warm-up
    # Phase-level: replicate the ctor's pipeline with explicit timers.
    tg, n_tgt = pad_cloud(
        np.asarray(tgt, np.float64), params.pad_multiple, pad_value=0.0
    )
    phases = {}
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        grid = build_grid_host(tg, params.radius, num_valid=n_tgt)
        t1 = time.perf_counter()
        plan = fp.plan_pool_host(grid, tg)
        t2 = time.perf_counter()
        demand = fp.estimate_pool_demand_rows(plan, src)
        t3 = time.perf_counter()
        pool = fp.build_pool_prepack(grid, tg, plan=plan)
        jax.block_until_ready(pool.pool_idx)
        t4 = time.perf_counter()
        for key, val in (
            ("grid_host", t1 - t0),
            ("plan", t2 - t1),
            ("demand", t3 - t2),
            ("prepack_upload_build", t4 - t3),
        ):
            phases.setdefault(key, []).append(val)
    # The bytes that actually cross the link (pool_seed_host is the upload
    # dict — d_cells / qmeta / width / union luts are derived on device).
    seed_bytes = sum(
        np.asarray(v).nbytes for v in fp.pool_seed_host(plan).values()
    )
    pair = {}
    for _ in range(args.repeats):
        for key, val in one_pair().items():
            pair.setdefault(key, []).append(val)
    emit(
        {
            "config": f"{args.fixture}{args.points // 1000}k_ctor_breakdown",
            "metric": "seconds",
            "unit": "s",
            "iters": args.iters,
            "seed_mb": round(seed_bytes / 1e6, 2),
            "phases_best": {
                k: round(min(v), 4) for k, v in phases.items()
            },
            "pair_best": {k: round(min(v), 4) for k, v in pair.items()},
            "pair_all": {
                k: [round(x, 4) for x in v] for k, v in pair.items()
            },
        }
    )


if __name__ == "__main__":
    main()
