"""BASELINE config #5 scaffold: pair-throughput scaling across devices.

Registers a batch of independent scan pairs with the batched engine
(parallel/batch.py) on 1, 2, ... N devices of the available platform and
reports pairs/s and scaling efficiency. On a CPU host set
``--backend cpu --host_devices 8`` to validate the sharding; on several
cards of one host the same script measures the scaling over their links.

Usage: python benchmarks/bench_scaling.py [--pairs 8] [--points 8192]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from common import emit, synthetic_sequence


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--n_outer", type=int, default=8)
    ap.add_argument("--backend", default=None,
                    help="JAX platform override (e.g. cpu)")
    ap.add_argument("--host_devices", type=int, default=None,
                    help="with --backend cpu: number of virtual host devices")
    ap.add_argument("--search_impl", default="brute",
                    choices=["brute", "grid", "auto"],
                    help="batched engine; brute keeps per-mesh-size compiles "
                         "fast (scaling efficiency is engine-orthogonal; the "
                         "grid path is parity-tested in tests/test_batch.py)")
    ap.add_argument("--mode", default="pair",
                    choices=["pair", "step", "decompose"],
                    help="pair: batch of independent pairs over the points "
                         "axis; step: ONE pair's sharded outer step (grid + "
                         "pooled engines) over 1/2/4/8 target shards — the "
                         "measurable proxy for collective/merge overhead")
    ap.add_argument("--steps", type=int, default=5,
                    help="step mode: timed step repetitions per mesh size")
    args = ap.parse_args()

    import os

    if args.host_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.host_devices}"
        ).strip()
    import jax

    if args.backend:
        jax.config.update("jax_platforms", args.backend)

    from probabilistic_point_clouds_registration_tpu.models.em_lm import LMConfig
    from probabilistic_point_clouds_registration_tpu.parallel import make_mesh
    from probabilistic_point_clouds_registration_tpu.parallel.batch import (
        run_odometry_batched,
    )

    if args.mode == "step":
        return step_scaling(args)
    if args.mode == "decompose":
        return decompose(args)

    scans, _ = synthetic_sequence(args.pairs + 1, args.points)
    cfg = LMConfig(dof=5.0, max_iterations=30)

    base_rate = None
    n_dev = jax.device_count()
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]
    for d in sizes:
        mesh = make_mesh(n_points_shards=d, n_target_shards=1,
                         devices=jax.devices()[:d])
        # Warm-up (compile), then timed run.
        for timed in (False, True):
            t0 = time.perf_counter()
            run_odometry_batched(
                scans, k=10, radius=0.1, lm_config=cfg, n_outer=args.n_outer,
                pad_multiple=1024, mesh=mesh, search_impl=args.search_impl,
            )
            seconds = time.perf_counter() - t0
        # The batched engine pads the pair batch to a multiple of the device
        # count with dummy self-pairs that do full work — rate over the
        # *padded* count is the machine's real throughput (the requested
        # count would understate it whenever pairs % devices != 0).
        padded_pairs = -(-args.pairs // d) * d
        rate = padded_pairs / seconds
        if base_rate is None:
            base_rate = rate
        emit(
            {
                "config": "pair_scaling",
                "devices": d,
                "metric": "scan_pairs_per_s",
                "value": round(rate, 4),
                "unit": "pairs/s",
                "efficiency_vs_1dev": round(rate / (base_rate * d), 3),
            }
        )


def step_scaling(args):
    """One pair's full sharded outer step (search + merge + EM-LM) over
    1/2/4/8 target shards, for both production engines.

    On virtual CPU devices the absolute times are a weak proxy (shards
    share host cores and the pooled kernel runs interpreted), but the
    RELATIVE per-shard work decomposition and the merge/collective payload
    are the real thing: each row also reports the all-gather merge payload
    in MB (what crosses the device links) so the overhead fraction can be
    bounded analytically against a known link bandwidth.
    """
    import time

    import jax
    import jax.numpy as jnp

    from probabilistic_point_clouds_registration_tpu.core import backend
    from probabilistic_point_clouds_registration_tpu.core.types import pad_cloud
    from probabilistic_point_clouds_registration_tpu.io.synthetic import bunny_like
    from probabilistic_point_clouds_registration_tpu.models.em_lm import LMConfig
    from probabilistic_point_clouds_registration_tpu.parallel import (
        build_sharded_grid_host,
        build_sharded_pool_host,
        build_sharded_pools_device,
        make_mesh,
        make_sharded_grid_registration_step,
        make_sharded_pool_registration_step,
    )

    on_card = backend.platform() == "gpu"
    k, radius = 20, 0.075
    n = args.points if args.points != 8192 else (35_000 if on_card else 12_000)
    tgt = bunny_like(n, seed=0)
    theta = 0.02
    rot = np.array(
        [
            [np.cos(theta), -np.sin(theta), 0.0],
            [np.sin(theta), np.cos(theta), 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    src = tgt @ rot.T + np.array([0.02, -0.015, 0.01])
    fs, n_src = pad_cloud(src.astype(np.float32), 1024, pad_value=0.0)
    tg, n_tgt = pad_cloud(tgt.astype(np.float32), 1024, pad_value=0.0)
    sv = np.arange(fs.shape[0]) < n_src
    cfg = LMConfig(dof=5.0, dimension=3, max_iterations=10)
    q0 = jnp.array([1.0, 0.0, 0.0, 0.0], jnp.float32)
    t0v = jnp.zeros(3, jnp.float32)

    n_dev = jax.device_count()
    sizes = [d for d in (1, 2, 4, 8) if d <= n_dev]
    base = {}
    for d in sizes:
        mesh = make_mesh(n_points_shards=1, n_target_shards=d,
                         devices=jax.devices()[:d])
        # All-gather volume per merge round: every device contributes
        # N x k x 20 B (distances + indices + coordinates); the gathered
        # result each device holds is d x that. Both are emitted — the
        # per-device contribution is what a ring all-gather sends per hop,
        # the total is a conservative link-traffic bound.
        contrib_mb = fs.shape[0] * k * (4 + 4 + 12) / 1e6
        payload_mb = contrib_mb * d

        for engine in ("grid", "pool"):
            if engine == "grid":
                sg = build_sharded_grid_host(tg, radius, d, num_valid=n_tgt)
                if sg is None:
                    continue
                step = make_sharded_grid_registration_step(
                    mesh, k=k, radius=radius, lm_config=cfg,
                    capacity=sg.capacity,
                )
                call = lambda: step(
                    jnp.asarray(fs), jnp.asarray(sv),
                    jnp.asarray(sg.bucket_pts, jnp.float32),
                    jnp.asarray(sg.bucket_idx), jnp.asarray(sg.lut),
                    jnp.asarray(sg.origin, jnp.float32), jnp.asarray(sg.dims),
                    q0, t0v, q0, t0v,
                )
            else:
                sp = build_sharded_pool_host(tg, radius, d, num_valid=n_tgt)
                if sp is None:
                    continue
                pools = build_sharded_pools_device(mesh, sp)
                pstep = make_sharded_pool_registration_step(
                    mesh, sp, k=k, radius=radius, lm_config=cfg,
                    source_rows_per_shard=fs.shape[0],
                )
                call = lambda: pstep(
                    jnp.asarray(fs), jnp.asarray(sv), pools, q0, t0v, q0, t0v
                )

            out = call()  # compile
            _ = float(out.result.final_cost)
            times = []
            for _i in range(args.steps):
                t0 = time.perf_counter()
                out = call()
                _ = float(out.result.final_cost)  # force fetch
                times.append(time.perf_counter() - t0)
            best = min(times)
            key = engine
            if key not in base:
                base[key] = best
            emit(
                {
                    "config": "step_scaling",
                    "engine": engine,
                    "target_shards": d,
                    "metric": "step_seconds",
                    "value": round(best, 4),
                    "unit": "s",
                    "points": n,
                    "speedup_vs_1shard": round(base[key] / best, 3),
                    "merge_contrib_mb_per_device": round(contrib_mb, 2),
                    "merge_allgather_total_mb": round(payload_mb, 2),
                    "backend": jax.default_backend(),
                }
            )


def decompose(args):
    """Per-shard WORK DECOMPOSITION of the sharded pooled step, both
    layouts (targets- vs points-sharding), stage by stage.

    On virtual CPU devices absolute wall times cannot show scaling
    (shards share the host's physical cores) — every emitted row says so
    in ``proxy`` — but the RELATIVE decomposition is meaningful on this
    proxy: search-only vs +merge vs +solve isolates where each layout
    spends, and the payload fields are exact models of what crosses the device links on
    hardware (all-gather: contrib x (T-1) per ring; butterfly tree:
    contrib x log2(T) — parallel/grid_sharded.py merge_topk_tree).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    from probabilistic_point_clouds_registration_tpu.core import backend
    from probabilistic_point_clouds_registration_tpu.core.se3 import quat_rotate
    from probabilistic_point_clouds_registration_tpu.core.types import pad_cloud
    from probabilistic_point_clouds_registration_tpu.io.synthetic import bunny_like
    from probabilistic_point_clouds_registration_tpu.models.em_lm import (
        LMConfig,
        em_lm_solve,
    )
    from probabilistic_point_clouds_registration_tpu.ops import fused_pool as _fp
    from probabilistic_point_clouds_registration_tpu.ops.fused_grid import (
        BLOCK_GROUPS,
        GROUP,
    )
    from probabilistic_point_clouds_registration_tpu.core.types import round_up
    from probabilistic_point_clouds_registration_tpu.parallel import (
        build_sharded_pool_host,
        build_sharded_pools_device,
        make_mesh,
    )
    from probabilistic_point_clouds_registration_tpu.parallel.grid_sharded import (
        sharded_merge_topk,
    )
    from probabilistic_point_clouds_registration_tpu.parallel.mesh import (
        POINTS_AXIS,
        TARGETS_AXIS,
    )

    P = jax.sharding.PartitionSpec
    on_card = backend.platform() == "gpu"
    k, radius = 20, 0.075
    n = args.points if args.points != 8192 else (35_000 if on_card else 12_000)
    tgt = bunny_like(n, seed=0)
    theta = 0.02
    rot = np.array(
        [
            [np.cos(theta), -np.sin(theta), 0.0],
            [np.sin(theta), np.cos(theta), 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    src = tgt @ rot.T + np.array([0.02, -0.015, 0.01])
    fs, n_src = pad_cloud(src.astype(np.float32), 1024, pad_value=0.0)
    tg, n_tgt = pad_cloud(tgt.astype(np.float32), 1024, pad_value=0.0)
    sv = np.arange(fs.shape[0]) < n_src
    cfg = LMConfig(dof=5.0, dimension=3, max_iterations=10,
                   axis_name=POINTS_AXIS)
    q0 = jnp.array([1.0, 0.0, 0.0, 0.0], jnp.float32)
    t0v = jnp.zeros(3, jnp.float32)
    contrib_mb = fs.shape[0] * k * (4 + 4 + 12) / 1e6

    def stage_step(mesh, sp, rows_per_shard, stage, tree):
        """Sharded pooled step truncated after ``stage`` (search | merge |
        full) — the same compute as make_sharded_pool_registration_step."""
        budget = round_up(
            max(sp.budget_rows, 8 * rows_per_shard), 2 * BLOCK_GROUPS * GROUP
        )
        ng = budget // GROUP
        scale = max(1, -(-budget // max(sp.budget_rows, 1)))
        budgets = tuple(
            min(ng, round_up(b * scale, BLOCK_GROUPS))
            for b in sp.class_budgets[:-1]
        ) + (ng,)

        def body(fs, sv, pool_xyz, pool_idx, width_lut, lut_d,
                 origin_d, dims_d):
            sq = lambda a: a.reshape(a.shape[1:])
            moved = quat_rotate(q0, fs) + t0v
            corr, overflow, pts = _fp.fused_pool_search(
                moved, sv,
                tuple(sq(x) for x in pool_xyz),
                tuple(sq(x) for x in pool_idx),
                sq(width_lut), sq(lut_d), sq(origin_d),
                sq(dims_d),
                k=k, radius=radius, class_widths=sp.class_widths,
                class_ends=sp.class_ends, class_budgets=budgets,
                budget_rows=budget,
                return_points=True,
                select_max_w=sp.select_max_w,
            )
            local_d = jnp.where(corr.mask, corr.sq_dists, jnp.inf)
            if stage == "search":
                return lax.psum(
                    lax.psum(jnp.sum(jnp.where(jnp.isfinite(local_d),
                                               local_d, 0.0)), TARGETS_AXIS),
                    POINTS_AXIS,
                )
            best_i, best_d, found, best_p = sharded_merge_topk(
                local_d, corr.indices, pts, k=k, axis_name=TARGETS_AXIS,
                tree=tree,
            )
            if stage == "merge":
                return lax.psum(
                    jnp.sum(jnp.where(found, best_d, 0.0)), POINTS_AXIS
                )
            res = em_lm_solve(moved, best_p, found, q0, t0v, cfg)
            return res.final_cost

        nc = len(sp.class_widths)
        return jax.jit(
            jax.shard_map(
                body, mesh=mesh,
                in_specs=(
                    P(POINTS_AXIS), P(POINTS_AXIS),
                    (P(TARGETS_AXIS),) * nc, (P(TARGETS_AXIS),) * nc,
                    P(TARGETS_AXIS), P(TARGETS_AXIS), P(TARGETS_AXIS),
                    P(TARGETS_AXIS),
                ),
                out_specs=P(),
                check_vma=False,
            )
        )

    n_dev = jax.device_count()
    sizes = [d for d in (1, 2, 4, 8) if d <= n_dev]
    for d in sizes:
        layouts = [("targets", 1, d)]
        if d > 1:
            layouts.append(("points", d, 1))
        for layout, dp, tp in layouts:
            mesh = make_mesh(n_points_shards=dp, n_target_shards=tp,
                             devices=jax.devices()[:d])
            sp = build_sharded_pool_host(tg, radius, tp, num_valid=n_tgt)
            if sp is None:
                continue
            pools = build_sharded_pools_device(mesh, sp)
            rows_per_shard = fs.shape[0] // dp
            fs_j, sv_j = jnp.asarray(fs), jnp.asarray(sv)
            row = {
                "config": "step_decompose",
                "layout": layout,
                "devices": d,
                "points": n,
                "unit": "s",
                "backend": jax.default_backend(),
                "proxy": (
                    None if on_card else
                    "virtual CPU devices share host cores: wall times "
                    "cannot show scaling; only the relative stage "
                    "decomposition and the payload models are meaningful"
                ),
                "merge_allgather_mb": round(contrib_mb * max(tp - 1, 0), 2),
                "merge_tree_mb": round(
                    contrib_mb * (tp - 1).bit_length(), 2
                ) if (tp & (tp - 1)) == 0 else None,
            }
            for stage in ("search", "merge", "full"):
                if layout == "points" and stage == "merge":
                    # tp=1: the merge is a no-op reshape.
                    row["merge_s"] = None
                    continue
                step = stage_step(mesh, sp, rows_per_shard, stage,
                                  tree=None)
                args_all = (
                    fs_j, sv_j, pools.pool_xyz, pools.pool_idx,
                    pools.width_lut, pools.lut_d,
                    pools.origin_d, pools.dims_d,
                )
                float(step(*args_all))  # compile
                times = []
                for _ in range(args.steps):
                    t0 = time.perf_counter()
                    float(step(*args_all))
                    times.append(time.perf_counter() - t0)
                row[f"{stage}_s"] = round(min(times), 4)
            full, search = row["full_s"], row["search_s"]
            after_merge = row["merge_s"] if row["merge_s"] is not None else search
            if full:
                row["search_share"] = round(search / full, 3)
                row["merge_share"] = round(
                    max(after_merge - search, 0.0) / full, 3
                )
                row["solve_share"] = round(
                    max(full - after_merge, 0.0) / full, 3
                )
            emit(row)


if __name__ == "__main__":
    main()
