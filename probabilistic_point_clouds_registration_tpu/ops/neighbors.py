"""Radius-bounded K-nearest-neighbor search (data association).

Device-native replacement for the reference's per-point FLANN kd-tree radius
search (src/prob_point_cloud_registration.cc:66-81: a kd-tree is rebuilt on
the target every outer iteration, then each source point runs
``radiusSearch(radius, max_neighbours)`` returning up to K nearest neighbors
within the radius, sorted by distance).

A kd-tree is the wrong shape for an accelerator: pointer chasing, dynamic
traversal, no dense work. Instead the (N_src x M_tgt) squared-distance
problem is tiled blockwise — the cross term is a matrix product — with a
streaming
top-K merge so the full distance matrix never materializes (the
flash-attention pattern applied to K-selection). Results are exactly the K
nearest within the radius, sorted ascending by distance: semantically equal
to FLANN's sorted, capped radiusSearch (tie *order* may differ; the
association set is identical up to distance ties).

Tie-order bound (measured, tests/test_tie_sensitivity.py): every engine
always returns all neighbors strictly closer than the k-th distance and
nothing farther — divergence between engines/FLANN is confined to which
members of the EXACT-tie class at the k-th slot are kept. On a maximally
tied integer lattice this engine matches a (distance, lowest-index) oracle
on 100% of rows; the grid engine's cell-bucket enumeration picks other
tie-class members on ~48% of rows there. Equal distances get equal E-step
weights, so the EM cost surface is invariant to the choice; real
(non-quantized) clouds tie with probability ~0.

This is the plain-XLA brute engine: the exact reference every other engine
is tested against (in float64 it is the on-card reference of chip_smoke.py),
and the engine for dense scans where a grid does not pay.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..core.types import Correspondences, round_up

_BIG = jnp.inf


def _match_vma(x, *refs):
    """Make ``x`` vary over every shard_map mesh axis any of ``refs`` vary on.

    Inside ``shard_map`` a freshly-created constant is unvarying, so using it
    as a scan carry whose body mixes in device-varying data trips the vma
    check; ``lax.pvary`` promotes it. No-op outside shard_map.
    """
    try:
        want = frozenset().union(*(jax.typeof(r).vma for r in refs))
        have = jax.typeof(x).vma
    except AttributeError:  # older JAX without vma tracking
        return x
    missing = want - have
    return jax.lax.pcast(x, tuple(missing), to="varying") if missing else x


def _pairwise_sq_dists(src: jnp.ndarray, tgt: jnp.ndarray) -> jnp.ndarray:
    """(S, T) squared distances via the matmul expansion."""
    # Accumulate in at least f32 even for bf16 inputs (f64 stays f64), at
    # full precision: a TF32 cross term would swamp the distance gaps.
    acc = jnp.promote_types(src.dtype, jnp.float32)
    cross = jnp.dot(
        src, tgt.T, preferred_element_type=acc,
        precision=jax.lax.Precision.HIGHEST,
    ).astype(src.dtype)
    s2 = jnp.sum(src * src, axis=-1, keepdims=True)
    t2 = jnp.sum(tgt * tgt, axis=-1)[None, :]
    return jnp.maximum(s2 + t2 - 2.0 * cross, 0.0)


@partial(jax.jit, static_argnames=("k", "source_tile", "target_tile", "exact"))
def topk_neighbors(
    source: jnp.ndarray,
    target: jnp.ndarray,
    *,
    k: int,
    source_valid: jnp.ndarray,
    target_valid: jnp.ndarray,
    source_tile: int = 4096,
    target_tile: int = 2048,
    exact: bool = False,
):
    """K nearest target points per source point (unbounded radius).

    Args:
      source: (N, 3) padded source cloud.
      target: (M, 3) padded target cloud.
      k: neighbors per source point (static).
      source_valid / target_valid: bool validity masks for padded rows.
      source_tile / target_tile: static tile sizes for the streaming sweep.
      exact: compute tile distances with the direct (s - t)^2 form
        instead of the matmul expansion. The expansion's f32 error is
        ~eps * max coordinate magnitude squared, which at LiDAR scales
        (+-75 m -> ~1e-3 m^2) swamps millimeter-scale distance gaps and
        corrupts SELECTION, not just the reported values. Use for small
        target sets (e.g. the hot-cell overflow merge) where matrix-unit
        throughput doesn't matter.

    Returns:
      (indices (N, k) int32, sq_dists (N, k), found (N, k) bool), sorted
      ascending by squared distance; ``found`` is False for slots beyond the
      number of valid targets and for invalid source rows.

    Numerical note: in the default (matmul-expansion) mode, both clouds are
    centered on the valid targets' bbox midpoint before the expansion, which
    shrinks the cancellation error from eps*|coords|^2 to eps*extent^2/4, and
    the final k results are re-sorted by exactly-recomputed distances. The
    selection itself remains approximate at the k-th boundary within that
    error band (the grid/fused engines compute exact gathered differences
    and have no such band).
    """
    n, _ = source.shape
    m, _ = target.shape
    dtype = source.dtype

    n_pad = round_up(n, source_tile)
    m_pad = round_up(m, target_tile)
    src = jnp.pad(source, ((0, n_pad - n), (0, 0)))
    tgt = jnp.pad(target, ((0, m_pad - m), (0, 0)))
    tgt_valid = jnp.pad(target_valid.astype(bool), (0, m_pad - m))
    if not exact:
        tv3 = tgt_valid[:, None]
        lo = jnp.min(jnp.where(tv3, tgt, jnp.inf), axis=0)
        hi = jnp.max(jnp.where(tv3, tgt, -jnp.inf), axis=0)
        center = jnp.where(jnp.isfinite(lo) & jnp.isfinite(hi), (lo + hi) * 0.5, 0.0)
        src = src - center.astype(dtype)
        tgt = tgt - center.astype(dtype)

    num_t_tiles = m_pad // target_tile

    def search_block(src_blk):  # (S, 3) -> ((S, k), (S, k))
        s = src_blk.shape[0]
        init = (
            _match_vma(jnp.full((s, k), _BIG, dtype), src_blk, tgt),
            _match_vma(jnp.full((s, k), m, dtype=jnp.int32), src_blk, tgt),
        )

        def step(carry, t_idx):
            best_d, best_i = carry
            start = t_idx * target_tile
            tile = lax.dynamic_slice(tgt, (start, jnp.int32(0)), (target_tile, 3))
            tile_valid = lax.dynamic_slice(tgt_valid, (start,), (target_tile,))
            if exact:
                diff = src_blk[:, None, :] - tile[None, :, :]
                d2 = jnp.sum(diff * diff, axis=-1).astype(dtype)
            else:
                d2 = _pairwise_sq_dists(src_blk, tile)
            d2 = jnp.where(tile_valid[None, :], d2, _BIG)
            tile_ids = (start + jax.lax.broadcasted_iota(jnp.int32, (s, target_tile), 1)).astype(
                jnp.int32
            )
            cand_d = jnp.concatenate([best_d, d2], axis=1)
            cand_i = jnp.concatenate([best_i, tile_ids], axis=1)
            neg_best, args = lax.top_k(-cand_d, k)
            return (-neg_best, jnp.take_along_axis(cand_i, args, axis=1)), None

        (best_d, best_i), _ = lax.scan(step, init, jnp.arange(num_t_tiles, dtype=jnp.int32))
        return best_d, best_i

    src_blocks = src.reshape(n_pad // source_tile, source_tile, 3)
    best_d, best_i = lax.map(search_block, src_blocks)
    best_d = best_d.reshape(n_pad, k)[:n]
    best_i = best_i.reshape(n_pad, k)[:n]

    found = (best_i < m) & jnp.isfinite(best_d) & source_valid.astype(bool)[:, None]
    safe_i = jnp.where(found, best_i, 0)
    # Recompute selected distances exactly (the matmul expansion loses a few
    # ulps; the gather-based form is what FLANN reports) and re-sort by them:
    # within the expansion's error band, selection order can invert.
    diff = source[:, None, :] - target[safe_i]
    exact_d = jnp.sum(diff * diff, axis=-1)
    sq_dists = jnp.where(found, exact_d, _BIG)
    if not exact:
        order = jnp.argsort(sq_dists, axis=1, stable=True)
        safe_i = jnp.take_along_axis(safe_i, order, axis=1)
        sq_dists = jnp.take_along_axis(sq_dists, order, axis=1)
        found = jnp.take_along_axis(found, order, axis=1)
    return safe_i, sq_dists, found


@partial(jax.jit, static_argnames=("k", "source_tile", "target_tile"))
def radius_search(
    source: jnp.ndarray,
    target: jnp.ndarray,
    *,
    k: int,
    radius: float,
    source_valid: jnp.ndarray,
    target_valid: jnp.ndarray,
    source_tile: int = 4096,
    target_tile: int = 2048,
) -> Correspondences:
    """Radius-bounded capped KNN: the reference's data-association search.

    Equivalent to ``kdtree.radiusSearch(pt, radius, max_neighbours)`` per
    source point (src/prob_point_cloud_registration.cc:72-81): at most ``k``
    neighbors, all within ``radius``, nearest-first.
    """
    idx, sq, found = topk_neighbors(
        source,
        target,
        k=k,
        source_valid=source_valid,
        target_valid=target_valid,
        source_tile=source_tile,
        target_tile=target_tile,
    )
    in_radius = found & (sq <= jnp.asarray(radius, sq.dtype) ** 2)
    return Correspondences(indices=idx, sq_dists=jnp.where(in_radius, sq, 0.0), mask=in_radius)


def nearest_neighbor(source, target, *, source_valid=None, target_valid=None):
    """1-NN distances+indices (the eval-utility primitive, utilities.hpp:28-63)."""
    n = source.shape[0]
    m = target.shape[0]
    if source_valid is None:
        source_valid = jnp.ones((n,), bool)
    if target_valid is None:
        target_valid = jnp.ones((m,), bool)
    idx, sq, found = topk_neighbors(
        source,
        target,
        k=1,
        source_valid=source_valid,
        target_valid=target_valid,
        source_tile=min(4096, round_up(n, 8)),
        target_tile=min(2048, round_up(m, 8)),
    )
    return idx[:, 0], sq[:, 0], found[:, 0]
