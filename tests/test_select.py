"""The select of the pooled and fused engines against a brute reference.

``_xla_class_select`` (plain XLA) and the Pallas select kernel (interpret
mode on the CPU) must both return, per source row, the k smallest
in-radius f32 squared distances of its group's window, ascending, ties
broken by lane — checked slot for slot against a numpy brute force at
window widths 64-4096, on invalid rows, dead windows and whole dead
kernel blocks, with the chosen candidates' coordinates.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from probabilistic_point_clouds_registration_tpu.ops.fused_grid import (
    GROUP,
    _xla_class_select,
    select_cols,
)
from probabilistic_point_clouds_registration_tpu.ops.select_kernel import (
    KERNEL_GROUPS,
    kernel_select,
)

_BIG = np.float32(1e30)


def _case(w, k, seed=0, n_win=6, groups=4 * KERNEL_GROUPS):
    """Pool windows + grouped source rows. Groups 0..KERNEL_GROUPS-1 all
    point at the dead window (one whole dead kernel block); some later
    groups too. Every 11th row is an invalid (unfilled) slot."""
    rng = np.random.default_rng(seed)
    live = int(w * 0.9)
    pool = rng.uniform(0.0, 1.0, (n_win + 1, 3, w)).astype(np.float32)
    idx = rng.permutation(np.arange(100, 100 + (n_win + 1) * w))
    idx = idx.reshape(n_win + 1, w).astype(np.int32)
    pool[:, :, live:] = _BIG
    idx[:, live:] = -1
    pool[n_win] = _BIG
    idx[n_win] = -1
    # Exact distance ties: duplicated candidates two lanes apart.
    pool[:, :, 7] = pool[:, :, 5]
    width = np.full((n_win + 1,), w, np.int32)
    width[n_win] = 0
    win = rng.integers(0, n_win, groups).astype(np.int32)
    win[:KERNEL_GROUPS] = n_win
    win[KERNEL_GROUPS + 1] = n_win
    rows = np.zeros((groups * GROUP, 4), np.float32)
    for g in range(groups):
        ctr = pool[win[g], :, :live]
        ctr = ctr.mean(axis=1) if win[g] < n_win else np.zeros(3)
        for s in range(GROUP):
            r = g * GROUP + s
            rows[r, :3] = ctr + rng.normal(scale=0.05, size=3)
            rows[r, 3] = float(r % 11 != 3)
    # ~2k candidates of a window's live lanes in radius on average.
    radius = float((2.0 * k / live * 3 / (4 * np.pi)) ** (1 / 3))
    return rows, pool, idx, win, width, radius


def _brute(rows, pool, idx, win, k, radius):
    """Numpy reference: (d2, idx, xyz) per row, ascending (d2, lane)."""
    n = rows.shape[0]
    kp = select_cols(k)
    out_d = np.full((n, kp), 3e38, np.float32)
    out_i = np.full((n, kp), -1, np.int32)
    out_p = np.zeros((n, 3, kp), np.float32)
    r2 = np.float32(radius) ** 2
    for r in range(n):
        wrow = win[r // GROUP]
        c = pool[wrow]
        if rows[r, 3] == 0:
            continue
        dx = c[0] - rows[r, 0]
        dy = c[1] - rows[r, 1]
        dz = c[2] - rows[r, 2]
        with np.errstate(over="ignore"):  # dead lanes sit at 1e30
            d2 = dx * dx + dy * dy + dz * dz
        lane = np.arange(c.shape[1])
        ok = (idx[wrow] >= 0) & (d2 <= r2)
        cand = lane[ok]
        order = cand[np.lexsort((cand, d2[cand]))][:k]
        m = order.size
        out_d[r, :m] = d2[order]
        out_i[r, :m] = idx[wrow, order]
        out_p[r, :, :m] = c[:, order]
    return out_d, out_i, out_p


def _check(got, want, k):
    gd, gi = np.asarray(got[0]), np.asarray(got[1])
    wd, wi, wp = want
    np.testing.assert_array_equal(gi[:, :k], wi[:, :k])
    m = wi[:, :k] >= 0
    np.testing.assert_allclose(gd[:, :k][m], wd[:, :k][m], rtol=3e-7)
    pts = np.stack([np.asarray(p)[:, :k] for p in got[2]], axis=1)
    np.testing.assert_array_equal(
        np.where(m[:, None, :], pts, 0.0), wp[:, :, :k]
    )


CASES = [(w, k) for w in (64, 512, 4096) for k in (8, 20, 40)] + [
    (128, 20),
    (256, 8),
]


@pytest.mark.parametrize("w, k", CASES)
def test_xla_select_matches_brute(w, k):
    rows, pool, idx, win, width, radius = _case(w, k)
    got = _xla_class_select(
        jnp.asarray(rows), jnp.asarray(pool[win]), jnp.asarray(idx[win]),
        k=k, kp=select_cols(k), radius=radius, return_points=True,
    )
    want = _brute(rows, pool, idx, win, k, radius)
    assert (want[1][:, 0] >= 0).mean() > 0.5  # the fixture finds neighbours
    _check(got, want, k)


@pytest.mark.parametrize("w, k", CASES)
def test_kernel_matches_brute(w, k):
    """The Pallas kernel (interpret mode on the CPU) against the same
    reference: it reads the pool in place by window row."""
    rows, pool, idx, win, width, radius = _case(w, k)
    got = kernel_select(
        jnp.asarray(rows), jnp.asarray(pool), jnp.asarray(idx),
        jnp.asarray(win), jnp.asarray(width),
        k=k, kp=select_cols(k), radius=radius, return_points=True,
    )
    _check(got, _brute(rows, pool, idx, win, k, radius), k)


def test_kernel_rejects_unaligned_rows():
    rows, pool, idx, win, width, radius = _case(128, 8)
    with pytest.raises(ValueError, match="multiple of"):
        kernel_select(
            jnp.asarray(rows[:-GROUP]), jnp.asarray(pool), jnp.asarray(idx),
            jnp.asarray(win[:-1]), jnp.asarray(width),
            k=8, kp=32, radius=radius, return_points=False,
        )


def test_select_cols():
    assert [select_cols(k) for k in (1, 20, 32, 33, 40, 100)] == [
        32, 32, 32, 64, 64, 128,
    ]


def _dot_precisions(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out += _dot_precisions(sub)
    return out


def test_moment_contractions_run_at_highest_precision():
    """Every contraction over points in the LM solve (and the brute
    engine's distance cross term) asks for HIGHEST precision: a GPU may
    otherwise run f32 dots in TF32."""
    from probabilistic_point_clouds_registration_tpu.models.em_lm import (
        LMConfig,
        em_lm_solve,
    )
    from probabilistic_point_clouds_registration_tpu.ops.neighbors import (
        _pairwise_sq_dists,
    )

    n, k = 64, 4
    src = jnp.zeros((n, 3), jnp.float32)
    tgt = jnp.zeros((n, k, 3), jnp.float32)
    mask = jnp.ones((n, k), bool)
    q0 = jnp.array([1.0, 0, 0, 0], jnp.float32)
    t0 = jnp.zeros((3,), jnp.float32)
    closed = jax.make_jaxpr(
        lambda *a: em_lm_solve(*a, LMConfig(max_iterations=2))
    )(src, tgt, mask, q0, t0)
    prec = _dot_precisions(closed.jaxpr)
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert len(prec) >= 4
    assert all(p == highest for p in prec), prec
    prec = _dot_precisions(
        jax.make_jaxpr(_pairwise_sq_dists)(src, src).jaxpr
    )
    assert prec == [highest]


@pytest.mark.gpu
def test_kernel_compiled_on_card():
    """The kernel compiled for the card (no interpreter) agrees with the
    XLA select; chip_smoke.py runs the full-width version of this."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run python chip_smoke.py on one)")
    rows, pool, idx, win, width, radius = _case(512, 20)
    got = kernel_select(
        jnp.asarray(rows), jnp.asarray(pool), jnp.asarray(idx),
        jnp.asarray(win), jnp.asarray(width),
        k=20, kp=32, radius=radius, return_points=True,
    )
    _check(got, _brute(rows, pool, idx, win, 20, radius), 20)
