"""Parity of the fused grouped engine (ops/fused_grid.py) vs the XLA grid
engine — neighbor sets must be identical (interpret-mode kernel on CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu.core.types import pad_cloud, valid_mask
from probabilistic_point_clouds_registration_tpu.ops.fused_grid import (
    build_prepack,
    fused_grid_search,
)
from probabilistic_point_clouds_registration_tpu.ops.grid import (
    HashGrid,
    build_grid,
    build_grid_host,
    grid_search,
)


def _make_pair(n_src=1500, n_tgt=2048, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    # Clustered cloud so cells have multi-point occupancy (the fused engine's
    # operating regime; scattered sources overflow by design — see the
    # dedicated overflow test).
    centers = rng.uniform(0, scale, size=(40, 3))
    tgt = (centers[rng.integers(0, 40, n_tgt)] +
           rng.normal(scale=0.025 * scale, size=(n_tgt, 3)))
    src = (centers[rng.integers(0, 40, n_src)] +
           rng.normal(scale=0.025 * scale, size=(n_src, 3)))
    return src.astype(np.float32), tgt.astype(np.float32)


def _run_both(src, tgt, radius, k):
    src_p, n_src = pad_cloud(src, 128, pad_value=0.0)
    tgt_p, n_tgt = pad_cloud(tgt, 128, pad_value=0.0)
    gh = build_grid_host(tgt_p, radius, num_valid=n_tgt)
    assert gh is not None
    grid = build_grid(tgt_p, radius, num_valid=n_tgt)
    # Production (the registration ctor) runs both engines on f32 bucket
    # coordinates; parity is defined at that operating point.
    grid = grid._replace(
        bucket_pts=jnp.asarray(grid.bucket_pts, jnp.float32),
        origin=jnp.asarray(grid.origin, jnp.float32),
    )
    sv = valid_mask(src_p.shape[0], n_src)
    ref = grid_search(grid, jnp.asarray(src_p, jnp.float32), k=k, radius=radius,
                      source_valid=sv)
    pre = build_prepack(gh, grid)
    assert pre is not None
    got, overflow = fused_grid_search(
        jnp.asarray(src_p, jnp.float32), sv,
        pre.cand_xyz, pre.cand_idx, pre.width_lut, pre.lut_d, pre.origin_d,
        pre.dims_d, k=k, radius=radius, )
    return ref, got, int(overflow), n_src


def test_fused_matches_grid_engine():
    src, tgt = _make_pair()
    ref, got, overflow, n = _run_both(src, tgt, radius=0.12, k=10)
    assert overflow == 0
    np.testing.assert_array_equal(np.asarray(got.mask)[:n], np.asarray(ref.mask)[:n])
    m = np.asarray(ref.mask)[:n]
    np.testing.assert_array_equal(
        np.asarray(got.indices)[:n][m], np.asarray(ref.indices)[:n][m]
    )
    # Distances agree to f32 ULP (XLA may contract the mul+add chain into
    # FMAs; the neighbor *sets* above are required to match exactly).
    np.testing.assert_allclose(
        np.asarray(got.sq_dists)[:n][m].astype(np.float32),
        np.asarray(ref.sq_dists)[:n][m].astype(np.float32),
        rtol=3e-7, atol=1e-9,
    )


def test_fused_sources_outside_grid_have_no_neighbors():
    src, tgt = _make_pair()
    src[:50] += 100.0  # far outside the target bbox
    ref, got, overflow, n = _run_both(src, tgt, radius=0.12, k=8)
    assert overflow == 0
    assert not np.asarray(got.mask)[:50].any()
    np.testing.assert_array_equal(np.asarray(got.mask)[:n], np.asarray(ref.mask)[:n])


def test_fused_padding_rows_are_empty():
    src, tgt = _make_pair(n_src=200)
    ref, got, overflow, n = _run_both(src, tgt, radius=0.12, k=8)
    assert not np.asarray(got.mask)[n:].any()
    assert np.asarray(got.indices)[n:].max(initial=0) == 0


def test_fused_overflow_flag_fires_on_scattered_sources():
    """Every source alone in its own cell needs 8 rows per source — the 2N
    group budget must overflow and the flag must report it."""
    rng = np.random.default_rng(1)
    n = 256
    # Regular lattice with spacing 1, radius 0.4 -> every point its own cell.
    xs = np.arange(8)
    grid_pts = np.stack(np.meshgrid(xs, xs, np.arange(4)), -1).reshape(-1, 3)
    src = grid_pts[:n].astype(np.float32)
    tgt = (grid_pts[:n] + 0.05).astype(np.float32)
    src_p, n_src = pad_cloud(src, 128, pad_value=0.0)
    tgt_p, n_tgt = pad_cloud(tgt, 128, pad_value=0.0)
    gh = build_grid_host(tgt_p, 0.4, num_valid=n_tgt)
    grid = build_grid(tgt_p, 0.4, num_valid=n_tgt)
    pre = build_prepack(gh, grid)
    sv = valid_mask(src_p.shape[0], n_src)
    got, overflow = fused_grid_search(
        jnp.asarray(src_p, jnp.float32), sv,
        pre.cand_xyz, pre.cand_idx, pre.width_lut, pre.lut_d, pre.origin_d,
        pre.dims_d, k=4, radius=0.4, )
    assert overflow > 0
    # Non-overflowed sources must still be correct.
    ref = grid_search(grid, jnp.asarray(src_p, jnp.float32), k=4, radius=0.4,
                      source_valid=sv)
    ok = np.asarray(got.mask)[:n_src].any(axis=1)
    m = np.asarray(ref.mask)[:n_src] & ok[:, None]
    np.testing.assert_array_equal(
        np.asarray(got.indices)[:n_src][m], np.asarray(ref.indices)[:n_src][m]
    )


def test_fused_registration_matches_grid_engine():
    """Full outer-loop registration via the fused engine must reproduce the
    XLA grid engine's trajectory (same associations -> same solves)."""
    from probabilistic_point_clouds_registration_tpu.core.params import (
        RegistrationParams,
    )
    from probabilistic_point_clouds_registration_tpu.models.registration import (
        register_pair,
    )

    src, tgt = _make_pair()
    src = src + np.array([0.02, -0.015, 0.01], np.float32)
    finals = {}
    for impl in ("fused", "grid"):
        p = RegistrationParams(
            max_neighbours=10, radius=0.12, n_iter=4, cost_drop_thresh=-1.0,
            dof=5.0, search_impl=impl, dtype="float32", outer_chunk=2,
        )
        T, reg = register_pair(src, tgt, p)
        if impl == "fused":
            assert reg._prepack is not None, "fused engine must have engaged"
        finals[impl] = T
    np.testing.assert_allclose(finals["fused"], finals["grid"], atol=1e-5)


def test_fused_wide_windows_past_4096_lanes():
    """Regression: windows wider than 4096 lanes (dense near-sensor core —
    capacity-driven widths the pool engine declines and routes here) must
    not lose candidates. A hardcoded 4096-lane bound on the grouped rows
    once made lanes >= 4096 invisible to the select kernel: wrong
    neighbors with overflow=0."""
    rng = np.random.default_rng(3)
    # A 3x3x3 block of hot cells (~200 points each): the center cell's
    # 27-cell union is ~5400 candidates > 4096 lanes (while << M so the
    # grid build doesn't decline for brute force). The TRUE nearest
    # neighbors are planted in the (+1,+1,+1) neighbor — offset 26, the
    # LAST neighbor of the window, lanes ~5200 — so the old hardcoded
    # 4096-lane bound masked exactly them. An anchor point at the origin
    # pins the grid so cell boundaries sit at exact multiples of 0.25.
    cell = 0.25
    ks = [1, 2, 3]
    centers = (
        (np.stack(np.meshgrid(ks, ks, ks), axis=-1).reshape(-1, 3) + 0.5)
        * cell
    ).astype(np.float32)
    vertex = np.float32(3 * cell)  # corner shared by center & (3,3,3) cell
    core = []
    for c in centers:
        if np.all(c > vertex):  # the (3,3,3) cell: plant it AT the vertex
            pts = vertex + np.abs(
                rng.normal(scale=0.002, size=(200, 3))
            ).astype(np.float32)
        else:
            pts = c + rng.normal(scale=0.01, size=(200, 3)).astype(
                np.float32
            )
        core.append(pts)
    shell = rng.uniform(0.0, 12.0, size=(12_000, 3)).astype(np.float32)
    tgt = np.concatenate([np.zeros((1, 3), np.float32)] + core + [shell])
    # Sources just inside the center cell's +corner: nearest = the vertex
    # cluster in offset-26 lanes.
    src = (
        vertex
        - np.float32(0.004)
        - np.abs(rng.normal(scale=0.002, size=(64, 3))).astype(np.float32)
    )
    ref, got, overflow, n = _run_both(src, tgt, radius=0.25, k=6)
    assert overflow == 0
    ref_d = np.sort(np.asarray(ref.sq_dists[:n]), axis=1)
    got_d = np.sort(np.asarray(got.sq_dists[:n]), axis=1)
    mask = np.asarray(ref.mask[:n])
    np.testing.assert_array_equal(np.asarray(got.mask[:n]), mask)
    np.testing.assert_allclose(got_d[mask], ref_d[mask], rtol=0, atol=1e-6)
