"""BASELINE configs #3/#4: sequential scan-to-scan odometry with ATE.

Runs the odometry pipeline over a sequence — real data when a directory of
scans is given (ETH ASL PCDs or a KITTI Velodyne sequence + poses/calib),
else a synthetic bunny-world sequence — and reports scan pairs/s and ATE
RMSE against ground truth.

Usage:
  python benchmarks/bench_sequence.py                       # synthetic
  python benchmarks/bench_sequence.py --scans /data/seq00/velodyne \
      --ground_truth /data/poses/00.txt --calib /data/seq00/calib.txt
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from common import emit, kitti_sequence, synthetic_sequence


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", default=None, help="directory of .pcd/.csv/.bin scans")
    ap.add_argument("--ground_truth", default=None)
    ap.add_argument("--calib", default=None)
    ap.add_argument("--n_scans", type=int, default=6, help="synthetic sequence length")
    ap.add_argument("--points", type=int, default=None)
    ap.add_argument(
        "--kitti_like", action="store_true",
        help="full-resolution LiDAR-like synthetic sequence (131k points, "
             "0.5 m radius): steady-state test of the pooled sparse engine "
             "+ the prep-thread overlap",
    )
    ap.add_argument(
        "--radius", type=float, default=None,
        help="search radius; defaults to 0.1 for the synthetic fixture and "
             "3.0 (the reference CLI default) for real meter-scale datasets",
    )
    ap.add_argument("--backend", default=None)
    ap.add_argument("--mesh", default=None, metavar="DPxTP",
                    help="run each pair's align on a DPxTP device mesh "
                         "(per-pair shard plans + pool builds staged on "
                         "the prep thread)")
    args = ap.parse_args()
    if args.backend:
        import jax

        jax.config.update("jax_platforms", args.backend)

    from probabilistic_point_clouds_registration_tpu import RegistrationParams
    from probabilistic_point_clouds_registration_tpu.models.odometry import run_odometry

    gt_poses = None
    if args.scans:
        from pathlib import Path

        from probabilistic_point_clouds_registration_tpu.io.kitti import (
            camera_poses_to_velodyne,
            list_velodyne_scans,
            load_calibration,
            load_poses,
        )

        from probabilistic_point_clouds_registration_tpu.io.eth_csv import (
            list_eth_scans,
        )

        d = Path(args.scans)
        scans = (
            sorted(d.glob("*.pcd"))
            or list_eth_scans(d)  # ETH ASL challenging-datasets CSVs
            or list_velodyne_scans(d)
        )
        label = f"sequence:{d.name}"
        if args.ground_truth:
            gt_poses = load_poses(args.ground_truth)
            if args.calib:
                gt_poses = camera_poses_to_velodyne(
                    gt_poses, load_calibration(args.calib)
                )
            anchor = np.linalg.inv(gt_poses[0])
            gt_poses = [anchor @ p for p in gt_poses]
    elif args.kitti_like:
        scans, gt_poses = kitti_sequence(args.n_scans, args.points or 131_072)
        label = "sequence:kitti_like"
    else:
        scans, gt_poses = synthetic_sequence(args.n_scans, args.points or 20_000)
        label = "sequence:synthetic"

    radius = args.radius if args.radius is not None else (
        3.0 if args.scans else (0.5 if args.kitti_like else 0.1)
    )
    params = RegistrationParams(
        max_neighbours=20,
        radius=radius,
        n_iter=12,
        cost_drop_thresh=0.005,
        dtype="float32",
        pad_multiple=4096 if args.kitti_like else 256,
        outer_chunk=12 if args.kitti_like else 4,
        max_inner_iterations=50 if args.kitti_like else 100,
    )
    mesh = None
    if args.mesh:
        from probabilistic_point_clouds_registration_tpu.parallel import (
            make_mesh,
        )

        dp, tp = (int(x) for x in args.mesh.lower().split("x"))
        mesh = make_mesh(dp, tp)

    # Two passes: the cold pass pays every one-time cost (compiles, first
    # uploads); the steady pass re-runs the identical sequence with every
    # program compiled and is the pipeline-throughput number the
    # prep-thread overlap targets. Both are emitted.
    for phase in ("cold", "steady"):
        t0 = time.perf_counter()
        result = run_odometry(scans, params, mesh=mesh)
        seconds = time.perf_counter() - t0
        n_pairs = len(result.relative_transforms)

        record = {
            "config": label + (f"_mesh{args.mesh}" if args.mesh else ""),
            "phase": phase,
            "radius": radius,
            "metric": "scan_pairs_per_s",
            "value": round(n_pairs / seconds, 4),
            "unit": "pairs/s",
            "n_pairs": n_pairs,
            "total_seconds": round(seconds, 2),
            # Truncated inner solves vs the reference's unbounded Ceres
            # (src/prob_point_cloud_registration.cc:96).
            "inner_cap_hits": result.inner_cap_hits,
        }
        if gt_poses is not None:
            from probabilistic_point_clouds_registration_tpu.utils.eval import (
                ate_rmse,
            )

            n = min(len(gt_poses), len(result.poses))
            record["ate_rmse"] = ate_rmse(result.poses[:n], gt_poses[:n])
        emit(record)


if __name__ == "__main__":
    main()
