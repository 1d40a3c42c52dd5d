"""Multi-device ``align()``: the full registration product loop on a mesh.

``DistributedRegistration`` is the drop-in multi-device counterpart of
models.registration.ProbabilisticRegistration (the reference's user-facing
unit, src/prob_point_cloud_registration.cc:63-136): same constructor shape
plus a ``mesh``, same ``align()`` / ``report()`` / ``transformation_history``
/ ``has_converged()`` surface, same CSV records and per-LM traces — not a
bare one-step function. Per chunk of outer iterations the host dispatches
ONE device program (make_sharded_pool_align_scan): the pooled engine
target-sharded over ``"targets"``, source rows and the 7x7
EM-LM normal equations psum-reduced over ``"points"``, and the reference
stopping rule carried on device so converged pairs stop computing
mid-chunk. The single-device bookkeeping (transform composition, stall
counter, MSE metrics, CSV rows) is inherited unchanged — device/host parity
is the same contract _consume_chunk already enforces.

Budget fallback: a pooled row-budget overflow first escalates the per-shard
budget (x2, twice — recompiling one scan), then falls back to the sharded
XLA grid engine for the rest of the pair (make_sharded_grid_align_scan) —
the multi-device analogue of the single-device mid-pair fallback.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.params import RegistrationParams
from ..core.se3 import np_matrix_to_quat
from ..core.types import round_up
from ..models.em_lm import LMConfig
from ..models.registration import ProbabilisticRegistration
from ..ops.voxel import voxel_downsample
from ..utils.eval import calculate_mse
from ..utils.ostream import OutputStream
from .grid_sharded import (
    build_sharded_grid_host,
    make_sharded_grid_align_scan,
)
from .mesh import POINTS_AXIS, TARGETS_AXIS, make_mesh
from .pool_sharded import (
    build_sharded_pool_host,
    build_sharded_pools_device,
    choose_pool_shard_layout,
    estimate_sharded_demand_rows,
    make_sharded_pool_align_scan,
)


class DistributedRegistration(ProbabilisticRegistration):
    """Full-outer-loop registration over a ``("points", "targets")`` mesh.

    Inherits every host-side product behavior from
    ProbabilisticRegistration (records, report CSV, convergence rule,
    ground-truth MSE, LM traces); only construction and the per-chunk
    device dispatch differ. Results match the single-device ``align()`` to
    float tolerance (tests/test_distributed_align.py asserts 5e-6 on the
    trajectory and slot-level record parity).
    """

    @staticmethod
    def prepare_target(
        target_cloud: np.ndarray,
        params: RegistrationParams,
        mesh: jax.sharding.Mesh,
        device: bool = False,
        layout: str = "auto",
        n_src_hint: Optional[int] = None,
    ) -> dict:
        """Host-side target prep for the MESH path — the multi-device
        counterpart of ProbabilisticRegistration.prepare_target.

        Pure numpy (layout choice + per-shard harmonized pool plans), so
        sequence pipelines run it on the target-prep thread while the
        current pair computes (models/odometry.py with ``mesh=``);
        ``device=True`` additionally dispatches the per-shard device pool
        builds (async — the upload/packing overlaps the current pair).

        The shard-axis layout must be decided HERE (the plan's shard count
        depends on it); ``n_src_hint`` feeds the occupancy chooser
        (default: the target's own size — consecutive scans of a sequence
        are statistically alike). Returns a dict for the constructor's
        ``prepared_target``; ``sp`` is None when the pooled engine
        declines the target (the caller falls back to a single-device
        registration for that pair).
        """
        target = np.asarray(target_cloud, dtype=np.float64)
        if params.target_filter_size > 0:
            target = voxel_downsample(target, params.target_filter_size)
        dp = mesh.shape[POINTS_AXIS]
        tp = mesh.shape[TARGETS_AXIS]
        est = None
        want = layout
        if want == "auto":
            if tp > 1:
                n_src = n_src_hint or target.shape[0]
                ijk = np.floor(
                    (target - target.min(axis=0)) / params.radius
                ).astype(np.int64)
                dims = ijk.max(axis=0) + 1
                lin = ijk[:, 0] + dims[0] * (ijk[:, 1] + dims[1] * ijk[:, 2])
                est = choose_pool_shard_layout(
                    n_src, target.shape[0], np.unique(lin).size, dp * tp, tp
                )
                want = est["layout"]
            else:
                want = "targets"
        if want == "points" and tp > 1:
            devs = mesh.devices.reshape(-1)
            mesh = make_mesh(devs.size, 1, devices=devs)
            tp = 1
        sp = build_sharded_pool_host(
            target, params.radius, tp, num_valid=target.shape[0],
        )
        prepared = {
            "target_cloud": target,
            "sp": sp,
            "mesh": mesh,
            "layout": "points" if want == "points" else "targets",
            "layout_estimate": est,
        }
        if device and sp is not None:
            from ..utils.compile_cache import (
                enable_persistent_compilation_cache,
            )

            enable_persistent_compilation_cache()
            prepared["pools"] = build_sharded_pools_device(
                mesh, sp, dtype=np.dtype(params.dtype)
            )
        return prepared

    def __init__(
        self,
        source_cloud: np.ndarray,
        target_cloud: np.ndarray,
        params: RegistrationParams,
        mesh: Optional[jax.sharding.Mesh] = None,
        ground_truth_cloud: Optional[np.ndarray] = None,
        layout: str = "auto",
        debug_replication: bool = False,
        prepared_target: Optional[dict] = None,
    ):
        if layout not in ("auto", "targets", "points"):
            raise ValueError(f"layout must be auto|targets|points: {layout}")
        # Runtime replication assert on every chunk's merged results (the
        # check_vma=False substitute for the pooled path); cheap relative
        # to the merge itself, but default-off in production.
        self._debug_replication = bool(debug_replication)
        # Shared host-side ctor pieces (base class): validation, streams,
        # compile cache, source load + voxel filter, ground-truth MSE.
        self._init_host_prelude(source_cloud, params)

        self.mesh = mesh if mesh is not None else make_mesh()
        self._dp = self.mesh.shape[POINTS_AXIS]
        self._tp = self.mesh.shape[TARGETS_AXIS]

        if prepared_target is not None:
            # Target prep (voxel filter, layout choice, harmonized
            # per-shard pool plans, optionally the device pool builds) ran
            # on a prep thread — adopt its outputs, including the layout
            # decision baked into the plan's shard count.
            target = prepared_target["target_cloud"]
            self.mesh = prepared_target["mesh"]
            self._dp = self.mesh.shape[POINTS_AXIS]
            self._tp = self.mesh.shape[TARGETS_AXIS]
            self.layout = prepared_target["layout"]
            self._layout_estimate = prepared_target.get("layout_estimate")
            self.target_cloud = target
            self._init_ground_truth(ground_truth_cloud)
        else:
            target = np.asarray(target_cloud, dtype=np.float64)
            if params.target_filter_size > 0:
                self.out << (
                    f"Filtering target point cloud with leaf of size "
                    f"{params.target_filter_size}\n"
                )
                target = voxel_downsample(target, params.target_filter_size)
            self.target_cloud = target

            self._init_ground_truth(ground_truth_cloud)

            # Occupancy-aware shard-axis choice (docs/PERF.md round-3
            # analysis: target-sharding inflates padded rows toward 8x on
            # sparse scans while points-sharding is occupancy-neutral; the
            # chooser compares estimated per-device select-kernel lane work
            # both ways).
            self._layout_estimate = None
            want = layout
            if want == "auto":
                if self._tp > 1:
                    pts = self.target_cloud
                    ijk = np.floor(
                        (pts - pts.min(axis=0)) / params.radius
                    ).astype(np.int64)
                    dims = ijk.max(axis=0) + 1
                    lin = ijk[:, 0] + dims[0] * (
                        ijk[:, 1] + dims[1] * ijk[:, 2]
                    )
                    self._layout_estimate = choose_pool_shard_layout(
                        self.filtered_source.shape[0],
                        pts.shape[0],
                        np.unique(lin).size,
                        self._dp * self._tp,
                        self._tp,
                    )
                    want = self._layout_estimate["layout"]
                else:
                    want = "targets"
            if want == "points" and self._tp > 1:
                # Collapse every device onto the "points" axis (device
                # order is preserved; the targets axis becomes size 1 and
                # the top-k merge degenerates to a no-op).
                devs = self.mesh.devices.reshape(-1)
                self.mesh = make_mesh(devs.size, 1, devices=devs)
                self._dp, self._tp = int(devs.size), 1
            self.layout = "points" if want == "points" else "targets"
        if self._layout_estimate is not None:
            e = self._layout_estimate
            self.out << (
                f"Shard layout: {self.layout} (est. lane work targets="
                f"{e['w_targets']:.3g} points={e['w_points']:.3g}, "
                f"occupancy/devrow={e['occ_per_devrow']:.2f})\n"
            )

        # Source rows padded so every "points" shard gets equal rows AND
        # each shard's rows divide the targets axis (the reduce-scatter
        # merge deals per-shard rows into tp contiguous blocks).
        n_src = self.filtered_source.shape[0]
        rows = round_up(
            round_up(n_src, params.pad_multiple),
            8 * self._dp * max(1, self._tp),
        )
        fs = np.zeros((rows, 3), np.float64)
        fs[:n_src] = self.filtered_source
        self._n_src = n_src
        np_dtype = np.dtype(params.dtype)
        P = jax.sharding.PartitionSpec
        pspec = jax.sharding.NamedSharding(self.mesh, P(POINTS_AXIS))
        self._filtered_src_dev = jax.device_put(fs.astype(np_dtype), pspec)
        self._src_valid = jax.device_put(np.arange(rows) < n_src, pspec)
        self._rows_per_shard = rows // self._dp

        # Target-sharded pooled prepack (the flagship engine; harmonized
        # per-shard plans — parallel/pool_sharded.py). The per-points-shard
        # source slices (under the initial pose) switch the row budget to
        # measured demand instead of the blunt 8x floor.
        from ..core.se3 import np_quat_to_matrix

        rot0 = np_quat_to_matrix(
            np.asarray(params.initial_rotation, np.float64)
        )
        moved0 = self.filtered_source @ rot0.T + np.asarray(
            params.initial_translation, np.float64
        )
        rps = rows // self._dp
        slices = [
            moved0[d * rps : min((d + 1) * rps, n_src)]
            for d in range(self._dp)
            if d * rps < n_src
        ]
        if prepared_target is not None:
            self._sp = prepared_target["sp"]
            if self._sp is not None:
                # The prep thread had no source, so the plan ships without
                # demand sizing — replay the grouping arithmetic from the
                # plan's own seeds against the real source slices here
                # (same numpy replay as the non-prepared path's
                # build_sharded_pool_host(source_slices=...)), sizing both
                # the row budget and the class-prefix budgets.
                demand, cum = estimate_sharded_demand_rows(
                    self._sp, slices, with_classes=True
                )
                from ..core.types import bucket_rows
                from ..ops.fused_pool import demand_class_budgets

                budgets = demand_class_budgets(
                    cum, self._sp.class_budgets[-1]
                )
                self._sp = self._sp._replace(
                    budget_rows=max(
                        self._sp.budget_rows,
                        bucket_rows(int(1.25 * demand), step_bits=3),
                    ),
                    class_budgets=budgets,
                    demand_sized=True,
                )
        else:
            self._sp = build_sharded_pool_host(
                target,
                params.radius,
                self._tp,
                num_valid=target.shape[0],
                source_slices=slices,
            )
        if self._sp is None:
            raise ValueError(
                "target does not fit the sharded pooled engine (degenerate "
                "cloud, oversized window union, or pool budget); use the "
                "single-device ProbabilisticRegistration for this pair"
            )
        if prepared_target is not None and "pools" in prepared_target:
            self._pools = prepared_target["pools"]
        else:
            self._pools = build_sharded_pools_device(
                self.mesh, self._sp, dtype=self.dtype
            )

        self._lm_config = self._make_lm_config(params)
        self._init_bookkeeping(params)
        self._scan = None  # built lazily per (engine, boost)
        self._grid_state = None  # sharded grid fallback, built on demand

    # -- device dispatch ----------------------------------------------------

    def _conv_statics(self) -> dict:
        p = self.params
        return dict(
            chunk=max(1, int(p.outer_chunk)),
            n_iter=int(p.n_iter),
            cost_drop_thresh=float(p.cost_drop_thresh),
            n_cost_drop_it=int(p.n_cost_drop_it),
        )

    def _make_pool_scan(self):
        p = self.params
        lm = self._lm_config
        if p.trace_inner:
            lm = lm._replace(trace=True)
        return make_sharded_pool_align_scan(
            self.mesh,
            self._sp,
            k=p.max_neighbours,
            radius=p.radius,
            lm_config=lm,
            source_rows_per_shard=self._rows_per_shard,
            budget_boost=self._pool_budget_boost,
            debug_replication=self._debug_replication,
            **self._conv_statics(),
        )

    def _ensure_grid_fallback(self):
        """Sharded XLA grid engine (built once, on first overflow past the
        budget escalation ladder)."""
        if self._grid_state is not None:
            return self._grid_state
        p = self.params
        sg = build_sharded_grid_host(
            self.target_cloud, p.radius, self._tp,
            num_valid=self.target_cloud.shape[0],
        )
        if sg is None:
            raise RuntimeError(
                "pooled budget overflow and the sharded grid fallback "
                "declined this target"
            )
        P = jax.sharding.PartitionSpec
        tspec = jax.sharding.NamedSharding(self.mesh, P(TARGETS_AXIS))
        rspec = jax.sharding.NamedSharding(self.mesh, P())
        np_dtype = np.dtype(p.dtype)
        lm = self._lm_config
        if p.trace_inner:
            lm = lm._replace(trace=True)
        scan = make_sharded_grid_align_scan(
            self.mesh,
            k=p.max_neighbours,
            radius=p.radius,
            lm_config=lm,
            capacity=sg.capacity,
            debug_replication=self._debug_replication,
            **self._conv_statics(),
        )
        self._grid_state = (
            scan,
            jax.device_put(sg.bucket_pts.astype(np_dtype), tspec),
            jax.device_put(sg.bucket_idx, tspec),
            jax.device_put(sg.lut, tspec),
            jax.device_put(sg.origin.astype(np_dtype), rspec),
            jax.device_put(sg.dims, rspec),
        )
        return self._grid_state

    def _align_loop(self) -> np.ndarray:
        import time

        p = self.params
        q0 = jnp.asarray(p.initial_rotation, dtype=self.dtype)
        t0 = jnp.asarray(p.initial_translation, dtype=self.dtype)
        chunk = max(1, int(p.outer_chunk))
        use_grid = False

        converged = False
        while not converged:
            conv0 = (
                np.float32(self.cost_drop),
                np.int32(self.num_unuseful_iter),
                np.int32(self.current_iteration),
            )
            if self.has_converged():
                break
            iter_start = time.perf_counter()
            t_cum = self.transformation()
            q_cum = jnp.asarray(
                np_matrix_to_quat(t_cum[:3, :3]), dtype=self.dtype
            )
            t_cum_dev = jnp.asarray(t_cum[:3, 3], dtype=self.dtype)
            if use_grid:
                scan, bp, bi, lut, origin, dims = self._ensure_grid_fallback()
                outs = scan(
                    self._filtered_src_dev, self._src_valid, bp, bi, lut,
                    origin, dims, q_cum, t_cum_dev, q0, t0, *conv0,
                )
                got = jax.device_get(outs)
                converged = self._consume_chunk(got, chunk, iter_start)
                continue
            if self._scan is None:
                self._scan = self._make_pool_scan()
            outs = self._scan(
                self._filtered_src_dev, self._src_valid, self._pools,
                q_cum, t_cum_dev, q0, t0, *conv0,
            )
            got = jax.device_get(outs)
            if int(np.sum(got[7])) > 0:
                # Budget overflow: escalate the pooled row budget, then
                # fall back to the sharded grid engine (see module doc).
                # Restore the stall counter the loop-top has_converged()
                # mutated for the discarded iteration.
                self.num_unuseful_iter = int(conv0[1])
                if self._pool_budget_boost < 2:
                    self._pool_budget_boost += 1
                    self._scan = None
                    self.out << (
                        "Sharded pooled budget overflow; retrying with a "
                        f"{1 << self._pool_budget_boost}x row budget\n"
                    )
                else:
                    use_grid = True
                    self.out << (
                        "Sharded pooled budget overflow; falling back to "
                        "the sharded XLA grid engine for this pair\n"
                    )
                continue
            converged = self._consume_chunk(
                got[:7] + got[8:], chunk, iter_start
            )

        if self.ground_truth:
            final = self.transformation()
            aligned = (
                self.source_cloud @ final[:3, :3].T + final[:3, 3]
            )
            self.mse_ground_truth = calculate_mse(
                aligned, self.ground_truth_cloud
            )
            print(f"MSE w.r.t. ground truth: {self.mse_ground_truth}")
        return self.transformation()
