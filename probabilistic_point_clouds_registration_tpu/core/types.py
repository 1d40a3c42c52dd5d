"""Dense, static-shape data structures for the device pipeline.

The reference stores data association as a row-major sparse matrix whose
*structure* (not values) drives the EM weight update
(src/prob_point_cloud_registration.cc:69-83, probabilistic_weights.hpp:48-105).
On the device that becomes a dense padded ``(N, K)`` neighbor table: indices,
squared distances, and a validity mask — XLA-friendly static shapes with
masked semantics identical to the sparse ones (a masked slot contributes
nothing, like an absent sparse entry).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class Correspondences(NamedTuple):
    """Padded (N, K) data-association table.

    Attributes:
      indices: int32 (N, K) target indices; arbitrary (clamped) where invalid.
      sq_dists: (N, K) squared search distances (diagnostic; like the sparse
        values in the reference, never consumed by the weight math).
      mask: bool (N, K); True where a real association exists.
    """

    indices: jnp.ndarray
    sq_dists: jnp.ndarray
    mask: jnp.ndarray


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pow2(n: int) -> int:
    """Smallest power of two >= n (>= 2): stabilizes data-dependent static
    sizes (scatter tables, class widths) across scans of a sequence."""
    return 1 << (max(int(n), 2) - 1).bit_length()


def bucket_rows(n: int, floor: int = 64, step_bits: int = 4) -> int:
    """Round ``n`` up at pow2 / 2**(step_bits-1) granularity (>= ``floor``;
    the default is ~12.5% steps).

    Static shapes derived from bucketed sizes repeat across scans of
    similar geometry, so per-pair jit programs are compiled once per
    sequence instead of once per pair. Sizes that JITTER across scans of
    one sequence right at a bucket boundary should use ``step_bits=3``
    (~25% steps): a KITTI-like sequence alternated one pool class
    between 26624 and 28672 padded windows, recompiling the ~minutes
    KITTI-scale scan program every OTHER pair — the coarser bucket eats
    the jitter for a few hundred KB of dead pool rows.
    """
    n = max(int(n), floor)
    q = max(floor, 1 << max(n.bit_length() - step_bits, 0))
    return round_up(n, q)


def pad_cloud(points: np.ndarray, multiple: int, pad_value: float = np.inf):
    """Pad an (n, 3) cloud to (round_up(n, multiple), 3).

    Returns (padded_points, n_valid). Padding rows are ``pad_value`` (+inf by
    default so padded points can never enter a nearest-neighbor set).
    """
    points = np.asarray(points)
    n = points.shape[0]
    n_pad = round_up(max(n, 1), multiple)
    if n_pad == n:
        return points, n
    padded = np.full((n_pad, points.shape[1]), pad_value, dtype=points.dtype)
    padded[:n] = points
    return padded, n


def valid_mask(n_total: int, n_valid, dtype=bool):
    """(n_total,) mask with the first ``n_valid`` entries True (jittable)."""
    return (jnp.arange(n_total) < n_valid).astype(dtype)
