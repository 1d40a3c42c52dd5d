"""The one backend decision (core/backend.py): its answers per platform and
grid capacity, the refusal of unknown platforms, and the guard that nothing
runs interpreted on the GPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu.core import backend


@pytest.fixture
def platform(monkeypatch):
    def set_platform(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)

    return set_platform


@pytest.mark.parametrize(
    "name, capacity, engine, select",
    [
        ("cpu", 64, "grid", "topk"),
        ("cpu", 128, "grid", "topk"),
        ("gpu", 64, "pool", "topk"),
        ("gpu", 128, "pool", "hier"),
    ],
)
def test_answers_per_platform_and_capacity(platform, name, capacity, engine,
                                           select):
    platform(name)
    assert backend.platform() == name
    assert backend.auto_engine() == engine
    assert backend.grid_select(capacity) == select


@pytest.mark.parametrize("name, interpret", [("cpu", True), ("gpu", False)])
def test_interpretation_only_on_cpu(platform, name, interpret):
    platform(name)
    assert backend.interpret_kernels() is interpret


@pytest.mark.parametrize(
    "question",
    [
        backend.platform,
        backend.auto_engine,
        lambda: backend.grid_select(64),
        lambda: backend.grid_select(4096),
        backend.interpret_kernels,
    ],
)
@pytest.mark.parametrize("name", ["rocm", "metal"])
def test_unknown_platform_raises(platform, question, name):
    platform(name)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        question()


def test_grid_select_boundary(platform):
    platform("gpu")
    hier = backend.GPU_HIER_MIN_CAPACITY
    assert backend.grid_select(hier // 2) == "topk"
    assert backend.grid_select(hier) == "hier"


def test_no_kernel_interpreted_on_gpu(platform, monkeypatch):
    """With the platform reported as "gpu", the select kernel is built with
    interpret=False (traced only; nothing runs)."""
    from jax.experimental import pallas as pl

    from probabilistic_point_clouds_registration_tpu.ops import select_kernel

    seen = []
    real = pl.pallas_call

    def spy(*args, **kwargs):
        seen.append(kwargs.get("interpret"))
        return real(*args, **{**kwargs, "interpret": True})

    monkeypatch.setattr(select_kernel.pl, "pallas_call", spy)
    platform("gpu")
    w, groups = 128, 4
    jax.eval_shape(
        lambda r, x, i, v, wl: select_kernel.kernel_select(
            r, x, i, v, wl, k=8, kp=32, radius=0.5, return_points=True
        ),
        jax.ShapeDtypeStruct((groups * 8, 4), jnp.float32),
        jax.ShapeDtypeStruct((3, 3, w), jnp.float32),
        jax.ShapeDtypeStruct((3, w), jnp.int32),
        jax.ShapeDtypeStruct((groups,), jnp.int32),
        jax.ShapeDtypeStruct((3,), jnp.int32),
    )
    assert seen == [False]


def test_registration_engines_never_interpret_on_gpu(platform, monkeypatch):
    """Every Pallas call a pooled registration builds while the platform
    reads "gpu" is compiled, never interpreted (the run itself stays on
    the CPU: the spy interprets so the suite can execute it)."""
    from jax.experimental import pallas as pl

    from probabilistic_point_clouds_registration_tpu import (
        ProbabilisticRegistration, RegistrationParams,
    )
    from probabilistic_point_clouds_registration_tpu.io.synthetic import (
        bunny_like,
    )
    from probabilistic_point_clouds_registration_tpu.ops import select_kernel

    seen = []
    real = pl.pallas_call

    def spy(*args, **kwargs):
        seen.append(kwargs.get("interpret"))
        return real(*args, **{**kwargs, "interpret": True})

    monkeypatch.setattr(select_kernel.pl, "pallas_call", spy)
    monkeypatch.setattr(backend, "SELECT_MAX_W", 8)
    platform("gpu")
    monkeypatch.setattr(
        "probabilistic_point_clouds_registration_tpu.utils.compile_cache"
        ".cache_dir", lambda name: None,
    )
    tgt = bunny_like(1500)
    src = tgt + np.array([0.01, 0.0, 0.0])
    params = RegistrationParams(
        radius=0.15, n_iter=1, cost_drop_thresh=-1.0, outer_chunk=1,
        search_impl="pool", max_neighbours=8,
    )
    reg = ProbabilisticRegistration(src, tgt, params)
    assert reg._pool is not None and reg._pool.select_max_w == 8
    reg.align()
    assert seen and not any(seen)
