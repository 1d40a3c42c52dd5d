"""End-to-end A/B of the neighbour-search variants on the card.

Times constructor + ``align()`` of bench.py's 35k bunny pair (dense regime)
and benchmarks/bench_kitti.py's 131k KITTI-like pair (sparse regime) under
these variants:

  a  XLA grid engine, flat ``lax.top_k`` select
  b  XLA grid engine, hierarchical (per-cell then merge) select
  c  pooled engine, every width class on the plain-XLA select
  d  pooled engine, the Pallas select kernel for classes wider than 64 lanes
     (the default)
  e  pooled engine, the Pallas select kernel for classes wider than 1024
     lanes
  f  as d, with a 128-lane pool class floor instead of
     ``fused_pool.MIN_CLASS_LANES`` (fewer, wider classes)
  g  pooled engine, the Pallas select kernel for every class

The pooled variants pass their select cutoff to ``build_pool_prepack`` as
an argument; f holds its floor for the one pair it builds. Each variant
compiles once (untimed), then the variants run in turns, forward and
reversed, ``--repeats`` times. Prints one JSON line per (regime, variant)
with every time (whole pair and constructor), the medians, and the
displacement of its final transform from the first variant's, after a line
naming the device and its power limit. ``--trace DIR`` then runs one more
warm pair of each ``--trace_variants`` variant under ``jax.profiler.trace``
into ``DIR/<regime>_<variant>`` (read with benchmarks/analyze_trace.py).

    python benchmarks/ab_select.py [--repeats 5] [--regimes bunny,kitti]
        [--variants a,b,c,d,e] [--trace DIR --trace_variants c,d]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from functools import partial
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "benchmarks")]

_ALL_XLA = 1 << 30
# Pooled variants: (pool class floor in lanes, None = the engine's; select
# cutoff: windows at or below it select in XLA, wider ones in the kernel).
_POOL = {
    "c": (None, _ALL_XLA),
    "d": (None, 64),
    "e": (None, 1024),
    "f": (128, 64),
    "g": (None, 0),
}
_GRID_SELECT = {"a": "topk", "b": "hier"}


def _pool_settings(variant):
    """Context that builds the pooled engine at ``variant``'s class floor
    and select cutoff."""
    from probabilistic_point_clouds_registration_tpu.ops import fused_pool as fp

    floor, cutoff = _POOL[variant]
    stack = contextlib.ExitStack()
    if floor is not None:
        stack.enter_context(mock.patch.object(fp, "MIN_CLASS_LANES", floor))
    stack.enter_context(mock.patch.object(
        fp, "build_pool_prepack",
        partial(fp.build_pool_prepack, select_max_w=cutoff),
    ))
    return stack


def _run(src, tgt, params, variant):
    from probabilistic_point_clouds_registration_tpu.models.registration import (
        ProbabilisticRegistration,
    )

    if variant in _GRID_SELECT:
        params = dataclasses.replace(
            params, search_impl="grid", search_select=_GRID_SELECT[variant]
        )
        settings = contextlib.nullcontext()
    else:
        params = dataclasses.replace(params, search_impl="pool")
        settings = _pool_settings(variant)
    with settings:
        t0 = time.perf_counter()
        reg = ProbabilisticRegistration(src, tgt, params)
        t1 = time.perf_counter()
        t = reg.align()
        sec = time.perf_counter() - t0
    engine = "pool" if reg._pool is not None else (
        "grid" if reg._grid is not None else "brute"
    )
    return sec, t1 - t0, t, engine, reg.inner_cap_hits


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--regimes", default="bunny,kitti")
    ap.add_argument("--variants", default="a,b,c,d,e")
    ap.add_argument("--trace", default=None,
                    help="directory for one traced warm pair per variant")
    ap.add_argument("--trace_variants", default="c,d")
    args = ap.parse_args()

    import jax

    import bench
    from bench_kitti import kitti_pair, kitti_params

    print(bench.device_line(), flush=True)
    pairs = {
        "bunny": lambda: (*bench.build_pair(35_000), bench.pair_params(15)),
        "kitti": lambda: (*kitti_pair(), kitti_params()),
    }
    variants = args.variants.split(",")
    for regime in args.regimes.split(","):
        src, tgt, params = pairs[regime]()
        finals, first, times, ctor, info = {}, {}, {}, {}, {}
        for v in variants:
            sec, _, t, engine, hits = _run(src, tgt, params, v)
            first[v], finals[v], info[v] = sec, t, (engine, hits)
            times[v], ctor[v] = [], []
        for r in range(args.repeats):
            order = variants if r % 2 == 0 else variants[::-1]
            for v in order:
                sec, sec_ctor, _, _, _ = _run(src, tgt, params, v)
                times[v].append(sec)
                ctor[v].append(sec_ctor)
        base = finals[variants[0]]
        a = src @ base[:3, :3].T + base[:3, 3]
        for v in variants:
            b = src @ finals[v][:3, :3].T + finals[v][:3, 3]
            print(json.dumps({
                "regime": regime,
                "variant": v,
                "engine": info[v][0],
                "inner_cap_hits": info[v][1],
                "first_call_s": first[v],
                "median_s": float(np.median(times[v])),
                "ctor_median_s": float(np.median(ctor[v])),
                "times_s": times[v],
                "ctor_s": ctor[v],
                "disp_vs_first_variant_max": float(
                    np.linalg.norm(a - b, axis=1).max()
                ),
            }), flush=True)
        if args.trace:
            for v in args.trace_variants.split(","):
                with jax.profiler.trace(str(Path(args.trace) / f"{regime}_{v}")):
                    _run(src, tgt, params, v)


if __name__ == "__main__":
    main()
