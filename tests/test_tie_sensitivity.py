"""Tie-order sensitivity of the k-th association slot.

FLANN's radiusSearch returns distance-sorted neighbors with ITS tie order
(prob_point_cloud_registration.cc:74-75); the rebuild's engines sort by
(f32 distance, candidate-slot order). On real clouds exact ties are measure
zero, but quantized clouds (voxelized exports, synthetic lattices) tie en
masse. This test pins down the invariant all engines guarantee:

  the selected set ALWAYS contains every neighbor strictly closer than the
  k-th distance, and every selected neighbor is within the k-th distance —
  i.e. divergence from any tie-breaking oracle is confined to the exact-tie
  equivalence class at the k-th slot, which carries no information the
  probabilistic weights could distinguish (equal distance = equal weight).
"""
import jax.numpy as jnp
import numpy as np

from probabilistic_point_clouds_registration_tpu.core.types import pad_cloud, valid_mask
from probabilistic_point_clouds_registration_tpu.ops.grid import build_grid, grid_search
from probabilistic_point_clouds_registration_tpu.ops.neighbors import radius_search

K, RADIUS = 10, 1.8


def _lattice():
    xs = np.arange(12, dtype=np.float64)
    pts = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    return pts  # 1728 points; neighbor shells at exact d2 = 0, 1, 2, 3, ...


def _oracle_sets(src, tgt, k, radius):
    """Per-row: (strictly-inside set, boundary d2, within-bound set)."""
    d2 = ((src[:, None, :] - tgt[None, :, :]) ** 2).sum(-1).astype(np.float32)
    r2 = np.float32(radius) ** 2
    inside, kth = [], []
    for row in d2:
        ok = np.nonzero(row <= r2)[0]
        order = ok[np.lexsort((ok, row[ok]))]  # (distance, index)
        sel = order[:k]
        kth_d2 = row[sel[-1]] if len(sel) else np.float32(np.inf)
        inside.append(set(ok[row[ok] < kth_d2]))
        kth.append(kth_d2)
    return inside, np.asarray(kth), d2


def _check_engine(idx, mask, inside, kth, d2, n):
    """All engines must satisfy the tie-class invariant; returns the fraction
    of rows whose set differs from the lowest-index-tie oracle."""
    diverged = 0
    for i in range(n):
        sel = set(idx[i][mask[i]].tolist())
        # every strictly-closer neighbor is present
        assert inside[i] <= sel, (i, inside[i] - sel)
        # nothing beyond the k-th distance is present
        for j in sel:
            assert d2[i, j] <= kth[i] + 1e-6, (i, j, d2[i, j], kth[i])
        # count rows where the tie-break landed differently than
        # "lowest index first"
        row = d2[i]
        ok = np.nonzero(row <= np.float32(RADIUS) ** 2)[0]
        order = ok[np.lexsort((ok, row[ok]))][:K]
        if sel != set(order.tolist()):
            diverged += 1
    return diverged / max(n, 1)


def test_tie_divergence_confined_to_kth_tie_class():
    tgt = _lattice()
    src = tgt.copy()  # sitting exactly on lattice points: maximal ties
    inside, kth, d2 = _oracle_sets(src, tgt, K, RADIUS)

    fs, n_src = pad_cloud(src, 128, 0.0)
    tg, n_tgt = pad_cloud(tgt, 128, 0.0)
    sv = valid_mask(fs.shape[0], n_src)
    tv = valid_mask(tg.shape[0], n_tgt)
    fs32 = jnp.asarray(fs, jnp.float32)
    tg32 = jnp.asarray(tg, jnp.float32)

    brute = radius_search(fs32, tg32, k=K, radius=RADIUS,
                          source_valid=sv, target_valid=tv)
    frac_brute = _check_engine(
        np.asarray(brute.indices), np.asarray(brute.mask), inside, kth, d2, n_src
    )

    grid = build_grid(tg, RADIUS, num_valid=n_tgt)
    assert grid is not None
    grid = grid._replace(bucket_pts=jnp.asarray(grid.bucket_pts, jnp.float32),
                         origin=jnp.asarray(grid.origin, jnp.float32))
    gcorr = grid_search(grid, fs32, k=K, radius=RADIUS, source_valid=sv)
    frac_grid = _check_engine(
        np.asarray(gcorr.indices), np.asarray(gcorr.mask), inside, kth, d2, n_src
    )

    # Document the measured scale of tie-order divergence vs a lowest-index
    # oracle on this maximally-tied fixture. The engines enumerate candidates
    # in different orders (global row order vs cell-bucket order), so some
    # rows pick different members of the k-th tie class — bounded, and
    # weight-equivalent by construction.
    assert 0.0 <= frac_brute <= 1.0
    assert 0.0 <= frac_grid <= 1.0
    print(f"tie divergence vs lowest-index oracle: brute={frac_brute:.3f} "
          f"grid={frac_grid:.3f}")


def test_ties_cannot_change_weights():
    """Two members of the same tie class get identical weights, so swapping
    them cannot change the EM cost surface: equal squared distances map to
    equal E-step weights."""
    from probabilistic_point_clouds_registration_tpu.ops.weights import update_weights

    e2 = jnp.asarray([[1.0, 2.0, 2.0, 3.0]])
    mask = jnp.ones((1, 4), bool)
    w = np.asarray(update_weights(e2, mask, dof=5.0, dimension=3))
    assert w[0, 1] == w[0, 2]
