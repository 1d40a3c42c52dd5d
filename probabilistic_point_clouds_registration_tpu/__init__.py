"""Probabilistic point-cloud registration in JAX, for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas re-design of probabilistic data-association ICP
(Agamennoni et al., IROS 2016) with the full capability surface of
iralabdisco/probabilistic_point_clouds_registration: radius-capped soft data
association, Student-t / Gaussian EM weighting, SE(3) Levenberg-Marquardt,
voxel filtering, PCD I/O, CSV iteration reports, evaluation metrics, a
flag-compatible CLI, and multi-device sharding for large clouds and
sequences.
"""

from .core.params import RegistrationParams
from .core.se3 import SE3
from .models.em_lm import LMConfig, em_lm_solve
from .models.registration import ProbabilisticRegistration, register_pair

__version__ = "0.1.0"

__all__ = [
    "RegistrationParams",
    "SE3",
    "LMConfig",
    "em_lm_solve",
    "ProbabilisticRegistration",
    "register_pair",
    "__version__",
]
