"""f32-vs-f64 end-to-end accuracy at the device operating point (SURVEY.md
§7 hard part (c)): the full pipeline in f32 — the dtype every device run uses —
must reproduce the f64 trajectory at bench scale.

Measured on this fixture (35k points, r=0.075, k=20): mean aligned-point
displacement between the f32 and f64 final transforms is ~5e-7 (max ~1e-6),
i.e. ~4 orders of magnitude under the mean point spacing (~0.019). The f32
accumulation of the 7x7 normal equations (models/em_lm.py:117-146) therefore
needs no compensated/f64 widening; the bound asserted here has ~20x margin.
"""
import numpy as np

from probabilistic_point_clouds_registration_tpu.core.params import RegistrationParams
from probabilistic_point_clouds_registration_tpu.models.registration import register_pair


def _pair(n=35_000):
    from probabilistic_point_clouds_registration_tpu.io.synthetic import bunny_like

    tgt = bunny_like(n, seed=0)
    theta = 0.02
    rot = np.array(
        [
            [np.cos(theta), -np.sin(theta), 0.0],
            [np.sin(theta), np.cos(theta), 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    src = tgt @ rot.T + np.array([0.02, -0.015, 0.01])
    return src, tgt


def test_f32_pipeline_matches_f64_at_operating_point():
    src, tgt = _pair()
    finals = {}
    for dt in ("float32", "float64"):
        p = RegistrationParams(
            max_neighbours=20, dof=5.0, radius=0.075, n_iter=3,
            cost_drop_thresh=-1.0, dtype=dt, pad_multiple=1024,
            max_inner_iterations=50,
        )
        T, _ = register_pair(src, tgt, p)
        finals[dt] = T
    a32 = src @ finals["float32"][:3, :3].T + finals["float32"][:3, 3]
    a64 = src @ finals["float64"][:3, :3].T + finals["float64"][:3, 3]
    disp = np.linalg.norm(a32 - a64, axis=1)
    # ATE-style bound: mean displacement far below the ~0.019 point spacing.
    assert disp.mean() < 1e-5, disp.mean()
    assert disp.max() < 5e-5, disp.max()
