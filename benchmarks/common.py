"""Shared helpers for the benchmark scripts (BASELINE.json configs).

Each script prints one JSON line per measured configuration:
{"config": ..., "metric": ..., "value": ..., "unit": ...} plus
config-specific fields. Synthetic stand-ins are generated when the real
datasets (Stanford Bunny, Kinect, ETH ASL, KITTI) are not on disk — the
repo, like the reference, ships no datasets.
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# Every emitted record also appends here (with a timestamp + backend). The
# default file is listed in .gitignore, so running a benchmark never dirties
# the checkout; PCR_BENCH_LOG points it elsewhere.
RESULTS_LOG = Path(
    os.environ.get("PCR_BENCH_LOG", REPO / "benchmarks" / "results.jsonl")
)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)
    try:
        import jax

        backend = jax.default_backend()
    except Exception:  # pragma: no cover - jax always importable here
        backend = "unknown"
    line = dict(record)
    line["_ts"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    line["_backend"] = backend
    with RESULTS_LOG.open("a") as f:
        f.write(json.dumps(line) + "\n")


def transformed_pair(points: np.ndarray, theta: float, translation) -> np.ndarray:
    rot = np.array(
        [
            [np.cos(theta), -np.sin(theta), 0.0],
            [np.sin(theta), np.cos(theta), 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    return points @ rot.T + np.asarray(translation)


def time_align(reg) -> float:
    t0 = time.perf_counter()
    reg.align()
    return time.perf_counter() - t0


def _sequence_from_world(world, theta, translation, n_scans):
    """Scans of a static world from a sensor moving by a fixed SE(3) step."""
    rot = np.array(
        [
            [np.cos(theta), -np.sin(theta), 0.0],
            [np.sin(theta), np.cos(theta), 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    delta = np.eye(4)
    delta[:3, :3] = rot
    delta[:3, 3] = translation
    pose = np.eye(4)
    scans, poses = [], []
    for _ in range(n_scans):
        inv = np.linalg.inv(pose)
        scans.append(world @ inv[:3, :3].T + inv[:3, 3])
        poses.append(pose.copy())
        pose = pose @ delta
    return scans, poses


def synthetic_sequence(n_scans: int, n_points: int = 20_000, seed: int = 0):
    """Scans of a bunny-like world seen from an incrementally moving sensor."""
    from probabilistic_point_clouds_registration_tpu.io.synthetic import bunny_like

    return _sequence_from_world(
        bunny_like(n_points, seed=seed), 0.015, [0.015, -0.01, 0.005], n_scans
    )


def kitti_sequence(n_scans: int, n_points: int = 131_072, seed: int = 0):
    """LiDAR-like scan sequence: a kitti_like world seen from a sensor
    moving ~0.8 m / 0.01 rad per step (KITTI-ish ego-motion at 10 Hz).
    Exercises the pooled sparse engine and the sequence pipeline's
    prep-thread overlap at full resolution."""
    from probabilistic_point_clouds_registration_tpu.io.synthetic import kitti_like

    return _sequence_from_world(
        kitti_like(n_points, seed=seed), 0.01, [0.8, 0.1, 0.02], n_scans
    )
