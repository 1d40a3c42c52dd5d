"""Fused EM E-step: probabilistic correspondence weights.

Device-native re-design of the reference's row-loop weight updater
(probabilistic_weights.hpp:48-105): instead of iterating sparse rows, the
whole (N, K) padded association table is processed as one fused vectorized
expression — per-slot log-probability, masked row logsumexp, posterior
softmax, and (t-distribution only) the expected-precision factor. XLA fuses
this into a single VPU pass; no Pallas needed because there is no matmul and
no reuse — it is purely elementwise + a K-wide row reduction.

Math parity (verified against the reference's golden test vectors in
tests/test_weights.py, from test/ProbabilisticWeightsTest.cc:35-66):

  t-distribution (dof = v < inf), d = residual dimension:
    t_exponent        = -(v + d) / 2                        (:37)
    log_norm_constant = lgamma(v/2) - lgamma((v+d)/2)
                        + (v/2) * log(pi * v)               (:39-41)
    log_prob          = t_exponent * log1p(e2 / v) - log_norm_constant (:71-72)
    expected_weight   = (v + d) / (v + e2)                  (:73-74)
    weight            = softmax_row(log_prob) * expected_weight (:96-98)

  Gaussian (v = inf):
    log_norm_constant = (d/2) * log(2 pi)                   (:42-45)
    log_prob          = -e2/2 + log_norm_constant           (:69)
    weight            = softmax_row(log_prob)               (:92-94)

  (The Gaussian branch *adds* the normalization constant — a sign quirk of
  the reference that is harmless because constants cancel in the row softmax;
  reproduced verbatim so intermediate log-probs match too.)

The row softmax is max-shifted exactly like the reference's manual
logsumexp (:77-87). Masked slots contribute nothing; fully-masked rows
produce all-zero weights (a sparse row with no entries produces no terms).
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp


def _t_constants(dof: float, dimension: int):
    t_exponent = -(dof + dimension) / 2.0
    log_norm_constant = (
        math.lgamma(dof / 2.0)
        - math.lgamma((dof + dimension) / 2.0)
        + (dof / 2.0) * math.log(math.pi * dof)
    )
    return t_exponent, log_norm_constant


@partial(jax.jit, static_argnames=("dof", "dimension"))
def update_weights(sq_errors: jnp.ndarray, mask: jnp.ndarray, *, dof: float, dimension: int):
    """Compute posterior association weights for one EM E-step.

    Args:
      sq_errors: (N, K) squared residual norms per association slot.
      mask: (N, K) bool; True where the slot holds a real association.
      dof: t-distribution degrees of freedom; ``inf`` selects the Gaussian.
      dimension: residual dimension d (3 in the registration pipeline,
        matching DIMENSIONS in prob_point_cloud_registration_iteration.hpp:17;
        the kernel is dimension-generic like the reference class).

    Returns:
      (N, K) weights; zero at masked slots and on fully-masked rows.
    """
    dtype = sq_errors.dtype
    neg_inf = jnp.asarray(-jnp.inf, dtype)

    if math.isinf(dof):
        log_norm_constant = (dimension / 2.0) * math.log(2.0 * math.pi)
        log_prob = -sq_errors / 2.0 + jnp.asarray(log_norm_constant, dtype)
        expected_weight = None
    else:
        t_exponent, log_norm_constant = _t_constants(dof, dimension)
        log_prob = jnp.asarray(t_exponent, dtype) * jnp.log1p(sq_errors / dof) - jnp.asarray(
            log_norm_constant, dtype
        )
        expected_weight = (dof + dimension) / (dof + sq_errors)

    log_prob = jnp.where(mask, log_prob, neg_inf)
    # Max-shifted logsumexp over the row (probabilistic_weights.hpp:77-87).
    row_max = jnp.max(log_prob, axis=-1, keepdims=True)
    any_valid = row_max > neg_inf
    safe_max = jnp.where(any_valid, row_max, 0.0)
    sum_exp = jnp.sum(jnp.where(mask, jnp.exp(log_prob - safe_max), 0.0), axis=-1, keepdims=True)
    log_marginal = jnp.log(jnp.where(any_valid, sum_exp, 1.0)) + safe_max

    weights = jnp.where(mask & any_valid, jnp.exp(log_prob - log_marginal), 0.0)
    if expected_weight is not None:
        weights = weights * expected_weight
    return weights
