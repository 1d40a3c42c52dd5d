"""Loop-timed probe of the pooled-engine search at KITTI/bunny scale.

Same-process A/B harness for select work: every number here scans the op
``--iters`` times inside ONE jit with a data dependency and fetches a
reduction, so per-dispatch overhead does not enter the per-iteration time.
``--select_max_w`` moves the XLA/kernel cutoff (0 = every class on the
Pallas kernel; a huge value = every class on XLA).

Usage: python benchmarks/probe_search.py [--points 131072] [--fixture kitti]
       [--iters 10]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from common import emit


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=131_072)
    ap.add_argument("--fixture", default="kitti", choices=["kitti", "bunny"])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--no_points", action="store_true")
    ap.add_argument("--demand_budget", action="store_true",
                    help="probe at the demand-lifted budget the product runs")
    ap.add_argument("--select_max_w", type=int, default=None,
                    help="widest class selected in XLA (default: the "
                         "backend's)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax import lax

    from probabilistic_point_clouds_registration_tpu.core.types import (
        pad_cloud,
    )
    from probabilistic_point_clouds_registration_tpu.io.synthetic import (
        bunny_like,
        kitti_like,
    )
    from probabilistic_point_clouds_registration_tpu.ops import fused_pool as fp
    from probabilistic_point_clouds_registration_tpu.ops.grid import (
        build_grid_host,
    )
    from probabilistic_point_clouds_registration_tpu.utils.compile_cache import (
        enable_persistent_compilation_cache,
    )

    enable_persistent_compilation_cache()

    if args.fixture == "kitti":
        tgt = kitti_like(args.points)
        radius, k, pad = 0.5, 20, 4096
        shift = np.array([0.8, 0.1, 0.02])
    else:
        tgt = bunny_like(args.points)
        radius, k, pad = 0.075, 20, 1024
        shift = np.array([0.02, -0.015, 0.01])
    src = tgt + shift

    tg, n_tgt = pad_cloud(tgt, pad, pad_value=0.0)
    fs, n_src = pad_cloud(src, pad, pad_value=0.0)
    grid = build_grid_host(tg, radius, num_valid=n_tgt)
    t0 = time.perf_counter()
    plan = fp.plan_pool_host(grid, tg)
    t_plan = time.perf_counter() - t0
    assert plan is not None
    t0 = time.perf_counter()
    pool = fp.build_pool_prepack(
        grid, tg, plan=plan, select_max_w=args.select_max_w
    )
    jax.device_get(jnp.sum(pool.pool_idx[0][:1]))  # force-fetch settle
    t_build = time.perf_counter() - t0

    fs_d = jax.device_put(fs.astype(np.float32))
    sv = jax.device_put(np.arange(fs.shape[0]) < n_src)
    return_points = not args.no_points

    budget_rows = pool.budget_rows
    if args.demand_budget:
        # Probe at the budget the PRODUCT actually runs: the ctor lifts the
        # plan's target-proxy budget to cover the real source's grouping
        # demand (models/registration.py) — glue work (grouping scatter,
        # class blends) scales with the row budget, so loop-timing the
        # bare plan budget would overstate the product's search.
        from probabilistic_point_clouds_registration_tpu.core.types import (
            bucket_rows,
        )

        demand = fp.estimate_pool_demand_rows(plan, src)
        budget_rows = max(
            budget_rows, bucket_rows(int(1.25 * demand), step_bits=3)
        )

    statics = dict(
        k=k,
        radius=radius,
        class_widths=pool.class_widths,
        class_ends=pool.class_ends,
        class_budgets=pool.class_budgets,
        budget_rows=budget_rows,
        return_points=return_points,
        select_max_w=pool.select_max_w,
    )

    from functools import partial

    @partial(jax.jit, static_argnames=tuple(statics))
    def scan_search(fs_d, sv, pool_arrs, **st):
        (pool_xyz, pool_idx, width_lut, lut_d, origin_d, dims_d) = pool_arrs

        def body(carry, _):
            src, acc = carry
            out = fp.fused_pool_search.__wrapped__(
                src, sv, pool_xyz, pool_idx, width_lut, lut_d, origin_d,
                dims_d, **st,
            )
            corr = out[0]
            # Data dependency: nudge the source by a tiny function of the
            # result so XLA cannot hoist iterations.
            eps = jnp.sum(corr.sq_dists) * 0.0
            return (src + eps, acc + jnp.sum(corr.sq_dists)), None

        (src, acc), _ = lax.scan(body, (fs_d, 0.0), None, length=args.iters)
        return acc

    pool_arrs = (
        pool.pool_xyz, pool.pool_idx, pool.width_lut, pool.lut_d, pool.origin_d, pool.dims_d,
    )

    t0 = time.perf_counter()
    jax.device_get(scan_search(fs_d, sv, pool_arrs, **statics))
    t_compile = time.perf_counter() - t0
    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        jax.device_get(scan_search(fs_d, sv, pool_arrs, **statics))
        times.append(time.perf_counter() - t0)
    per_iter = min(times) / args.iters
    emit(
        {
            "config": f"{args.fixture}{args.points // 1000}k_pool_search",
            "select_max_w": pool.select_max_w,
            "metric": "search_ms_per_iter",
            "value": round(per_iter * 1e3, 2),
            "unit": "ms",
            "iters": args.iters,
            "repeats": args.repeats,
            "return_points": return_points,
            "classes": list(pool.class_widths),
            "class_ends": list(pool.class_ends),
            "budget_rows": budget_rows,
            "plan_s": round(t_plan, 3),
            "build_settle_s": round(t_build, 3),
            "compile_s": round(t_compile, 1),
            "all_times": [round(t / args.iters * 1e3, 2) for t in times],
        }
    )


if __name__ == "__main__":
    main()
