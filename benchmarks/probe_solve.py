"""Loop-timed probe of the inner EM-LM solve at KITTI/bunny scale.

Isolates ``em_lm_solve`` (models/em_lm.py) from the search: synthesizes the
(N, K, 3) gathered-neighbor tensor + mask the search would produce and
loop-times LM iterations inside ONE jit (same measurement hygiene as
probe_search.py: data dependency between repeats, one scalar fetch).
Tolerances are set so the stopping tests cannot realistically fire
(ftol=-1 never holds for positive cost; xtol=0 needs a bitwise-zero step),
but the loop can still exit via dead trust-region radius — so per-step
time divides by the iterations that ACTUALLY ran (summed on device), not
the cap. Defaults amortize ~1000 LM steps per fetch so the host roundtrip
of the fetch contributes little to the quotient.

Usage: python benchmarks/probe_solve.py [--points 131072] [--k 20]
       [--lm_iters 50] [--fixture kitti]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from common import emit


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=131_072)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--lm_iters", type=int, default=50)
    ap.add_argument("--reps", type=int, default=20, help="solves per jit scan")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--fixture", default="kitti", choices=["kitti", "bunny"])
    ap.add_argument("--dof", type=float, default=5.0)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax import lax

    from probabilistic_point_clouds_registration_tpu.io.synthetic import (
        bunny_like,
        kitti_like,
    )
    from probabilistic_point_clouds_registration_tpu.models.em_lm import (
        LMConfig,
        em_lm_solve,
    )
    from probabilistic_point_clouds_registration_tpu.utils.compile_cache import (
        enable_persistent_compilation_cache,
    )

    enable_persistent_compilation_cache()

    rng = np.random.default_rng(0)
    gen = kitti_like if args.fixture == "kitti" else bunny_like
    src = gen(args.points).astype(np.float32)
    n, k = src.shape[0], args.k
    # Neighbors: the source point plus per-slot jitter at a plausible
    # residual scale; ~85% of slots valid like a real radius search.
    scale = 0.2 if args.fixture == "kitti" else 0.01
    tgts = src[:, None, :] + rng.normal(0.0, scale, (n, k, 3))
    mask = rng.random((n, k)) < 0.85
    mask[:, 0] = True

    # Disarm the stopping tests: ftol=-1 (|change| <= -cost never holds for
    # positive cost) and xtol=0 (threshold 0*(x_norm+0)=0, so only a
    # bitwise-zero step could fire; a NEGATIVE xtol would NOT disarm — the
    # threshold -1*(x_norm-1) is positive whenever |x| < 1). The loop can
    # still exit via dead trust-region radius, which is why per-step time
    # divides by the actual iteration count below. parameter_tolerance is
    # passed only when the installed solver has it (A/B vs older checkouts).
    kw = dict(
        dof=args.dof,
        max_iterations=args.lm_iters,
        function_tolerance=-1.0,
    )
    if "parameter_tolerance" in LMConfig._fields:
        kw["parameter_tolerance"] = 0.0
    cfg = LMConfig(**kw)

    src_d = jax.device_put(src.astype(np.float32))
    tgt_d = jax.device_put(tgts.astype(np.float32))
    mask_d = jax.device_put(mask)
    q0 = jnp.array([1.0, 0.0, 0.0, 0.0], jnp.float32)
    t0v = jnp.zeros(3, jnp.float32)

    @jax.jit
    def scan_solve(src_d, tgt_d, mask_d, q0, t0v):
        def body(carry, _):
            q, acc, iters = carry
            res = em_lm_solve(src_d, tgt_d, mask_d, q, t0v, cfg)
            # Data dependency across reps so XLA cannot hoist.
            eps = res.final_cost * 0.0
            return (q0 + eps, acc + res.final_cost,
                    iters + res.num_iterations), None

        (_, acc, iters), _ = lax.scan(
            body, (q0, 0.0, jnp.asarray(0, jnp.int32)), None, length=args.reps
        )
        return acc, iters

    t0 = time.perf_counter()
    _, iters = jax.device_get(scan_solve(src_d, tgt_d, mask_d, q0, t0v))
    t_compile = time.perf_counter() - t0
    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        jax.device_get(scan_solve(src_d, tgt_d, mask_d, q0, t0v))
        times.append(time.perf_counter() - t0)
    # The solves may still exit early via dead trust-region radius — divide
    # by the iterations that actually ran, not the cap.
    per_step = min(times) / int(iters)
    emit(
        {
            "config": f"{args.fixture}{args.points // 1000}k_em_lm",
            "metric": "lm_step_ms",
            "value": round(per_step * 1e3, 3),
            "unit": "ms",
            "lm_iters_ran": int(iters),
            "lm_iters_cap": args.lm_iters,
            "reps": args.reps,
            "k": k,
            "compile_s": round(t_compile, 1),
            "all_solve_ms": [
                round(t / args.reps * 1e3, 2) for t in times
            ],
        }
    )


if __name__ == "__main__":
    main()
