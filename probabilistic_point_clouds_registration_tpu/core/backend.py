"""What the accelerator this process runs on can do — the one backend decision.

Every engine choice that depends on the device reads its answer here, so
the platform is named in exactly one place. Two platforms are supported:

  * ``"gpu"`` — the production target (an NVIDIA H100). Every kernel runs
    compiled; nothing is interpreted and no engine is swapped silently.
  * ``"cpu"`` — the test suite. The Pallas select kernel runs in
    interpret mode here, which is the only place interpretation is allowed.

Any other platform raises: a silent fallback would hide the device.

The answers for ``"gpu"`` come from the end-to-end A/B on the card recorded
in ``docs/PERF.md`` ("Bring-up A/B").
"""
from __future__ import annotations

import jax

PLATFORMS = ("cpu", "gpu")

# Pooled/fused engines: candidate windows at or below this many lanes
# select in plain XLA (``fused_grid._xla_class_select``); wider ones run
# the Pallas select kernel (``ops/select_kernel.py``). The kernel skips a
# class pass's dead groups; the XLA select pays full width for them.
# Measured end to end on the card (docs/PERF.md, "Bring-up A/B").
SELECT_MAX_W = 64

# Engine that ``search_impl="auto"`` takes, per platform. On the card the
# pooled engine wins both measured pairs; on the CPU the XLA grid engine is
# both the fastest and the reference the test suite was built around.
_AUTO_ENGINE = {"cpu": "grid", "gpu": "pool"}

# The XLA grid engine's selection under ``search_select="auto"``: on the
# card the hierarchical select (per-cell top_k, then a merge) wins from
# this bucket capacity up (the 131k KITTI-like pair: capacity 128, 3,456
# flat lanes) and flat top_k below it (the 35k bunny pair: capacity 64).
# On the CPU flat top_k wins both.
GPU_HIER_MIN_CAPACITY = 128


def platform() -> str:
    """The platform of JAX's default backend: "gpu" or "cpu"; else raises."""
    name = jax.default_backend()
    if name not in PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {name!r}: this system runs on an "
            f"NVIDIA GPU, or on the CPU for tests"
        )
    return name


def auto_engine() -> str:
    """Search engine ``search_impl="auto"`` takes: "pool" or "grid"."""
    return _AUTO_ENGINE[platform()]


def grid_select(capacity: int) -> str:
    """Selection the XLA grid engine uses under ``search_select="auto"``
    for a grid of this bucket capacity: "topk" or "hier"."""
    if platform() == "gpu" and capacity >= GPU_HIER_MIN_CAPACITY:
        return "hier"
    return "topk"


def interpret_kernels() -> bool:
    """Whether Pallas kernels run in interpret mode: only on the CPU."""
    return platform() == "cpu"
