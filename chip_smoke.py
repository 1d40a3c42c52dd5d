#!/usr/bin/env python3
"""On-card smoke test: the main paths at full size on one NVIDIA GPU.

Runs, in ONE process (a second JAX process on the card would fail for
memory), each phase printing one line:

  0. device: fails unless JAX's default device is a GPU (no CPU fallback);
     prints the card's name and power limit, its device kind and the JAX
     version.
  1. 35k bunny pair (bench.py's pair and parameters), ``search_impl="auto"``
     in float32, against the exact float64 brute engine on the card.
  2. 131k KITTI-like pair (benchmarks/bench_kitti.py's pair and
     parameters), the same comparison.
  3. sequence and map path: ``run_odometry`` over 5 KITTI-like scans (with
     its prep-thread overlap), its first relative pose against the float64
     brute engine on that scan pair; then that pair through
     ``prepare_target(..., device=True)`` + ``prepared_target=``.
  4. the pair CLI, in-process (``cli.main``), on the bunny pair as PCD.
  5. the Pallas select kernel, compiled for the card, against the plain-XLA
     select (``fused_grid._xla_class_select``) on the windows both pairs
     really produce, with both times.

``--four-cards`` runs only the multi-device path: ``DistributedRegistration``
on a 4-card mesh in both layouts on both pairs, against one-card
``align()``. Any failed phase exits nonzero; the last line of a passing
run is ``{"ok": true, "device": {...}}``.

    python chip_smoke.py [--four-cards]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Final-transform agreement with the float64 brute engine: mean / max
# displacement of the aligned source points. Bunny: the f32 pipeline's
# bound at the operating point (tests/test_f32_accuracy.py; point spacing
# ~0.019). KITTI-like (coordinates to ~75 m, where one f32 ulp is 7.6e-6 m):
# room for 131k-term sums at full f32 precision.
BUNNY_TOL = (1e-5, 5e-5)
KITTI_TOL = (1e-4, 1e-3)


class PhaseError(RuntimeError):
    pass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def _load_repo():
    """Import the package and the benchmark helpers from this checkout."""
    sys.path[:0] = [str(REPO), str(REPO / "benchmarks")]
    import probabilistic_point_clouds_registration_tpu as pkg

    pkg_dir = Path(pkg.__file__).resolve().parent
    _check(
        pkg_dir.parent == REPO,
        f"package imported from {pkg_dir}, not from this checkout",
    )


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0] if out else ""


def _displacement(src, t_a, t_b):
    import numpy as np

    a = src @ t_a[:3, :3].T + t_a[:3, 3]
    b = src @ t_b[:3, :3].T + t_b[:3, 3]
    d = np.linalg.norm(a - b, axis=1)
    return float(d.mean()), float(d.max())


def _engine(reg) -> str:
    if reg._pool is not None:
        return "pool"
    if reg._prepack is not None:
        return "fused"
    return "grid" if reg._grid is not None else "brute"


def _register(src, tgt, params, **kw):
    from probabilistic_point_clouds_registration_tpu import (
        ProbabilisticRegistration,
    )

    t0 = time.perf_counter()
    reg = ProbabilisticRegistration(src, tgt, params, **kw)
    t = reg.align()
    return t, reg, time.perf_counter() - t0


def _reference(src, tgt, params):
    """The exact float64 brute engine on the card, same parameters.

    x64 is on only for this call, so every float32 path runs as users run
    it."""
    import jax

    ref = dataclasses.replace(params, dtype="float64", search_impl="brute")
    with jax.enable_x64(True):
        return _register(src, tgt, ref)


def _compare(name, src, t, t_ref, tol):
    mean, mx = _displacement(src, t, t_ref)
    _check(
        mean < tol[0] and mx < tol[1],
        f"{name}: displacement vs f64 brute mean {mean:.3e} (< {tol[0]}) "
        f"max {mx:.3e} (< {tol[1]})",
    )
    return mean, mx


def phase_pair(name, src, tgt, params, tol):
    t, reg, sec = _register(src, tgt, params)
    t_ref, reg_ref, sec_ref = _reference(src, tgt, params)
    mean, mx = _compare(name, src, t, t_ref, tol)
    return (
        f"{name}: engine={_engine(reg)} inner_cap_hits={reg.inner_cap_hits} "
        f"corr={reg.records[-1].num_correspondences} "
        f"ref_corr={reg_ref.records[-1].num_correspondences} "
        f"disp_mean={mean:.3e} disp_max={mx:.3e} "
        f"f32_s={sec:.3f} f64_brute_s={sec_ref:.3f} (first call, compile "
        f"included)"
    )


def phase_sequence(kitti_params):
    import numpy as np

    from common import kitti_sequence
    from probabilistic_point_clouds_registration_tpu import (
        ProbabilisticRegistration,
    )
    from probabilistic_point_clouds_registration_tpu.models.odometry import (
        run_odometry,
    )

    scans, poses = kitti_sequence(5, 131_072)
    params = kitti_params()
    t0 = time.perf_counter()
    res = run_odometry(scans, params)
    sec = time.perf_counter() - t0
    _check(len(res.relative_transforms) == 4, "run_odometry: 4 pairs expected")
    ate = res.ate_rmse(poses)
    _check(np.isfinite(ate), f"run_odometry: ATE {ate}")
    src, tgt = scans[1], scans[0]
    t_ref, _, _ = _reference(src, tgt, params)
    mean, mx = _compare(
        "run_odometry pair 0", src, res.relative_transforms[0], t_ref,
        KITTI_TOL,
    )
    prep = ProbabilisticRegistration.prepare_target(tgt, params, device=True)
    t_map, reg_map, _ = _register(src, tgt, params, prepared_target=prep)
    mean2, mx2 = _compare("prepared target", src, t_map, t_ref, KITTI_TOL)
    return (
        f"sequence: 5 scans x 131072 pts, {sec:.3f} s (compile included), "
        f"ATE {ate:.4e} m, pair0 disp_mean={mean:.3e} disp_max={mx:.3e}; "
        f"prepared target engine={_engine(reg_map)} disp_mean={mean2:.3e} "
        f"disp_max={mx2:.3e}"
    )


def phase_cli(src, tgt):
    import numpy as np

    from probabilistic_point_clouds_registration_tpu import cli
    from probabilistic_point_clouds_registration_tpu.io.pcd import save_pcd

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        save_pcd(os.path.join(tmp, "src.pcd"), src)
        save_pcd(os.path.join(tmp, "tgt.pcd"), tgt)
        os.chdir(tmp)
        try:
            rc = cli.main(["src.pcd", "tgt.pcd", "-r", "0.075", "--dump"])
            report = Path(tmp, "src_tgt_summary.txt")
            _check(rc == 0, f"cli.main returned {rc}")
            _check(report.exists(), "cli --dump wrote no summary")
            rows = [
                ln for ln in report.read_text().splitlines()
                if ln and ln[0].isdigit()
            ]
        finally:
            os.chdir(cwd)
    _check(len(rows) > 0, "cli summary holds no iteration rows")
    last = np.array([float(v) for v in rows[-1].split(",")[4:7]])
    _check(bool(np.all(np.isfinite(last))), f"cli final translation {last}")
    return f"cli: exit 0, {len(rows)} iterations, final t={last.tolist()}"


def _ulp_close(a, b, n_ulp):
    import numpy as np

    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    return np.abs(a - b) <= n_ulp * ulp


def _time(fn, reps=5):
    import jax

    jax.block_until_ready(fn())  # compile
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def _kernel_cases(src, tgt, params):
    """(rows4, pool_xyz, pool_idx, win, width) per kernel-class pass of the
    pooled engine on this pair, at the initial pose."""
    import jax.numpy as jnp
    import numpy as np

    from probabilistic_point_clouds_registration_tpu.core.types import (
        pad_cloud, round_up,
    )
    from probabilistic_point_clouds_registration_tpu.ops import fused_pool as fp
    from probabilistic_point_clouds_registration_tpu.ops.fused_grid import (
        BLOCK_GROUPS, GROUP, _group_by_window,
    )
    from probabilistic_point_clouds_registration_tpu.ops.grid import (
        build_grid_host,
    )

    tg, n_tgt = pad_cloud(tgt, params.pad_multiple, pad_value=0.0)
    gh = build_grid_host(
        tg, params.radius, num_valid=n_tgt,
        max_overflow=params.grid_max_overflow, buckets=False,
    )
    plan = fp.plan_pool_host(gh, tg)
    _check(plan is not None, "pool plan declined the pair")
    pre = fp.build_pool_prepack(gh, tg, plan=plan)
    sp, n_src = pad_cloud(src, params.pad_multiple, pad_value=0.0)
    demand = fp.estimate_pool_demand_rows(plan, src)
    s_pad = round_up(
        max(pre.budget_rows, int(1.25 * demand), sp.shape[0] + 4096),
        2 * BLOCK_GROUPS * GROUP,
    )
    padded, step_rows, *_ = _group_by_window(
        jnp.asarray(sp, jnp.float32),
        jnp.arange(sp.shape[0]) < n_src,
        pre.lut_d, pre.origin_d, pre.dims_d,
        pre.width_lut.shape[0] - 1, params.radius, s_pad,
    )
    cases = []
    prev = 0
    for c, (w_c, e_c) in enumerate(zip(pre.class_widths, pre.class_ends)):
        if w_c > pre.select_max_w:
            rows_c = step_rows
            in_class = (rows_c >= prev) & (rows_c < e_c)
            n_c = e_c - prev
            local = jnp.where(in_class, rows_c - prev, n_c)
            width = jnp.concatenate(
                [pre.width_lut[prev:e_c], jnp.zeros((1,), jnp.int32)]
            )
            live = np.asarray(in_class)
            keep = np.flatnonzero(live)
            if keep.size:
                # The class's own groups, padded to the kernel's block.
                g = keep[: (keep.size // BLOCK_GROUPS) * BLOCK_GROUPS]
                if g.size == 0:
                    g = np.resize(keep, BLOCK_GROUPS)
                rows = np.asarray(padded).reshape(-1, GROUP, 4)[g]
                cases.append((
                    w_c,
                    jnp.asarray(rows.reshape(-1, 4)),
                    pre.pool_xyz[c], pre.pool_idx[c],
                    jnp.asarray(np.asarray(local)[g]), width,
                ))
        prev = e_c
    return cases


def phase_kernel(pairs):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from probabilistic_point_clouds_registration_tpu.ops.fused_grid import (
        _xla_class_select, select_cols,
    )
    from probabilistic_point_clouds_registration_tpu.ops.select_kernel import (
        kernel_select,
    )

    lines = []
    for name, src, tgt, params in pairs:
        k = params.max_neighbours
        kp = select_cols(k)
        r2 = np.float32(params.radius) ** 2
        cases = _kernel_cases(src, tgt, params)
        _check(len(cases) > 0, f"{name}: no class runs the kernel")
        for w, rows, pxyz, pidx, win, width in cases:
            kern = jax.jit(lambda r, x, i, v, wd: kernel_select(
                r, x, i, v, wd, k=k, kp=kp, radius=params.radius,
                return_points=True,
            ))
            ref = jax.jit(lambda r, x, i, v: _xla_class_select(
                r, x[v], i[v], k=k, kp=kp, radius=params.radius,
                return_points=True,
            ))
            got = kern(rows, pxyz, pidx, win, width)
            want = ref(rows, pxyz, pidx, win)
            gd, gi = np.asarray(got[0])[:, :k], np.asarray(got[1])[:, :k]
            wd, wi = np.asarray(want[0])[:, :k], np.asarray(want[1])[:, :k]
            gf, wf = gi >= 0, wi >= 0
            # A candidate at the radius boundary may fall on either side
            # when FMA contraction differs: allowed within 2 ulp of r^2.
            diff_count = gf.sum(1) != wf.sum(1)
            for r in np.flatnonzero(diff_count):
                extra = np.concatenate([gd[r][gf[r]], wd[r][wf[r]]]).max()
                _check(
                    bool(_ulp_close(extra, r2, 2)),
                    f"{name} w={w}: row {r} found {gf[r].sum()} vs "
                    f"{wf[r].sum()} away from the radius",
                )
            both = gf & wf
            _check(
                bool(np.all(_ulp_close(gd[both], wd[both], 2))),
                f"{name} w={w}: distances differ by more than 2 ulp",
            )
            swap = both & (gi != wi)
            _check(
                bool(np.all(_ulp_close(gd[swap], wd[swap], 1))),
                f"{name} w={w}: {int(swap.sum())} index mismatches that "
                f"are not 1-ulp ties",
            )
            t_k = _time(lambda: kern(rows, pxyz, pidx, win, width))
            t_x = _time(lambda: ref(rows, pxyz, pidx, win))
            lines.append(
                f"{name} w={w} rows={rows.shape[0]}: kernel {t_k * 1e3:.3f} "
                f"ms, xla {t_x * 1e3:.3f} ms, index swaps {int(swap.sum())}"
            )
    return "kernel: " + "; ".join(lines)


def phase_four_cards(bunny, kitti):
    import jax

    from probabilistic_point_clouds_registration_tpu.parallel import (
        DistributedRegistration, make_mesh,
    )

    _check(len(jax.devices()) == 4, f"{len(jax.devices())} devices, need 4")
    lines = []
    for name, (src, tgt, params, tol) in (("bunny", bunny), ("kitti", kitti)):
        t1, _, _ = _register(src, tgt, params)
        for layout, shape in (("targets", (2, 2)), ("points", (4, 1))):
            mesh = make_mesh(n_points_shards=shape[0], n_target_shards=shape[1])
            t0 = time.perf_counter()
            reg = DistributedRegistration(
                src, tgt, params, mesh=mesh, layout=layout
            )
            t4 = reg.align()
            sec = time.perf_counter() - t0
            mean, mx = _displacement(src, t4, t1)
            _check(
                mean < tol[0] and mx < tol[1],
                f"{name} {layout}: 4-card vs 1-card mean {mean:.3e} max "
                f"{mx:.3e}",
            )
            lines.append(
                f"{name} {layout} {shape[0]}x{shape[1]}: disp_mean={mean:.3e} "
                f"disp_max={mx:.3e} {sec:.3f} s (compile included)"
            )
    return "four cards: " + "; ".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card DistributedRegistration path")
    args = ap.parse_args(argv)

    try:
        _load_repo()
    except (ImportError, PhaseError) as e:
        print(f"FAIL setup: {e}", flush=True)
        return 1
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"FAIL device: JAX platform is {dev.platform!r}, not 'gpu'",
              flush=True)
        return 1
    try:
        smi = _smi()
    except (OSError, subprocess.SubprocessError) as e:
        print(f"FAIL device: nvidia-smi: {e}", flush=True)
        return 1
    print(smi, flush=True)
    print(
        f"device: {dev.device_kind}, {len(jax.devices())} device(s), "
        f"jax {jax.__version__}",
        flush=True,
    )
    import bench
    from bench_kitti import kitti_pair, kitti_params

    bsrc, btgt = bench.build_pair(35_000)
    bparams = bench.pair_params(15)
    ksrc, ktgt = kitti_pair()
    kparams = kitti_params()

    if args.four_cards:
        phases = [(
            "four cards",
            lambda: phase_four_cards(
                (bsrc, btgt, bparams, BUNNY_TOL),
                (ksrc, ktgt, kparams, KITTI_TOL),
            ),
        )]
    else:
        phases = [
            ("bunny", lambda: phase_pair(
                "bunny 35k", bsrc, btgt, bparams, BUNNY_TOL)),
            ("kitti", lambda: phase_pair(
                "kitti 131k", ksrc, ktgt, kparams, KITTI_TOL)),
            ("sequence", lambda: phase_sequence(kitti_params)),
            ("cli", lambda: phase_cli(bsrc, btgt)),
            ("kernel", lambda: phase_kernel([
                ("bunny", bsrc, btgt, bparams),
                ("kitti", ksrc, ktgt, kparams),
            ])),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            line = fn()
        except PhaseError as e:
            print(f"FAIL {name}: {e}", flush=True)
            return 1
        print(f"PASS {line} [{time.perf_counter() - t0:.1f} s]", flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
