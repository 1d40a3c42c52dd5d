"""Native C++ runtime kernels: parity against the pure-Python fallbacks.

The Python implementations in io/pcd.py and ops/voxel.py are the oracles
(themselves golden-tested elsewhere); the native library must match them
bit-for-bit on the same inputs.
"""
import numpy as np
import pytest

from probabilistic_point_clouds_registration_tpu import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable (no g++?)"
)


def _python_lzf_roundtrip_reference(data: bytes) -> bytes:
    """Literal-run LZF encoding via the documented Python fallback path."""
    out = bytearray()
    for i in range(0, len(data), 32):
        chunk = data[i : i + 32]
        out.append(len(chunk) - 1)
        out += chunk
    return bytes(out)


def _python_lzf_decompress(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        ctrl = data[i]
        i += 1
        if ctrl < 32:
            run = ctrl + 1
            out += data[i : i + run]
            i += run
        else:
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = len(out) - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            for _ in range(length + 2):
                out.append(out[ref])
                ref += 1
    assert len(out) == expected
    return bytes(out)


@pytest.mark.parametrize("seed,size", [(0, 0), (1, 1), (2, 100), (3, 65_536)])
def test_lzf_roundtrip_random(seed, size):
    rng = np.random.default_rng(seed)
    # Mix of compressible (repeats) and random content.
    data = rng.integers(0, 8, size=size, dtype=np.uint8).tobytes()
    comp = native.lzf_compress(data)
    if size == 0:
        assert comp is None
        return
    assert comp is not None
    assert native.lzf_decompress(comp, size) == data
    # Cross-check: the Python decoder accepts the native encoder's stream.
    assert _python_lzf_decompress(comp, size) == data


def test_lzf_compresses_structured_data():
    """Point-cloud-like f32 data must actually shrink (the Python fallback
    only adds overhead; the native encoder is the real codec)."""
    rng = np.random.default_rng(0)
    # Quantized coordinates (sensor-like): plenty of repeated byte patterns.
    pts = (rng.integers(0, 200, size=(10_000, 3)) * 0.05).astype(np.float32)
    body = np.concatenate([pts[:, 0], pts[:, 1], pts[:, 2]]).tobytes()
    comp = native.lzf_compress(body)
    assert comp is not None
    assert len(comp) < len(body)
    assert native.lzf_decompress(comp, len(body)) == body


def test_native_decompress_accepts_python_stream():
    data = bytes(range(256)) * 10
    literal_stream = _python_lzf_roundtrip_reference(data)
    assert native.lzf_decompress(literal_stream, len(data)) == data


def test_native_decompress_rejects_corrupt():
    with pytest.raises(ValueError):
        native.lzf_decompress(b"\xff\xff\xff", 1000)


@pytest.mark.parametrize("seed,n,leaf", [(0, 1000, 0.5), (1, 5000, 0.25), (2, 37, 2.0)])
def test_voxel_native_matches_python(seed, n, leaf):
    from probabilistic_point_clouds_registration_tpu.ops import voxel

    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)) * 3.0

    got = native.voxel_downsample(pts, leaf)
    assert got is not None

    # Pure-Python oracle (force the fallback path).
    import os

    os.environ["PCR_DISABLE_NATIVE"] = "1"
    try:
        # Re-derive with the numpy branch by calling the internals directly.
        ijk = np.floor(pts / leaf).astype(np.int64)
        ijk -= ijk.min(axis=0)
        dims = ijk.max(axis=0) + 1
        lin = ijk[:, 0] + ijk[:, 1] * dims[0] + ijk[:, 2] * dims[0] * dims[1]
        uniq, inverse, counts = np.unique(lin, return_inverse=True, return_counts=True)
        sums = np.zeros((uniq.shape[0], 3), dtype=np.float64)
        np.add.at(sums, inverse, pts)
        want = sums / counts[:, None]
    finally:
        del os.environ["PCR_DISABLE_NATIVE"]

    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_pcd_binary_compressed_roundtrip_uses_native(tmp_path):
    from probabilistic_point_clouds_registration_tpu.io.pcd import load_pcd, save_pcd

    rng = np.random.default_rng(0)
    pts = rng.standard_normal((4096, 3)).astype(np.float32)
    p = tmp_path / "c.pcd"
    save_pcd(str(p), pts, mode="binary_compressed")
    out = load_pcd(str(p))
    np.testing.assert_allclose(out, pts, atol=0)


def test_native_dilate_cells_matches_numpy():
    """The C++ dilation must be byte-identical to the numpy body of
    dilate_cells_host (incl. the stable descending-union order and the
    27-offset tie contract)."""
    import numpy as np

    import probabilistic_point_clouds_registration_tpu.native as native
    from probabilistic_point_clouds_registration_tpu.io.synthetic import (
        bunny_like,
    )
    from probabilistic_point_clouds_registration_tpu.ops.fused_grid import (
        dilate_cells_host,
    )
    from probabilistic_point_clouds_registration_tpu.ops.grid import (
        build_grid_host,
    )

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")

    for seed, n in ((0, 5000), (3, 2000)):
        rng = np.random.default_rng(seed)
        if seed:
            tgt = rng.uniform(0, 12, size=(n, 3))
            tgt[:, 2] = rng.normal(scale=0.4, size=n)  # sparse sheet
        else:
            tgt = bunny_like(n, seed=seed)
        gh = build_grid_host(tgt, 0.35 if seed else 0.06)
        assert gh is not None
        counts = gh["cell_count"].astype(np.int64)

        # Force the numpy fallback for the reference (dilate_cells_host
        # dispatches to the native path when available).
        saved = native.dilate_cells
        try:
            native.dilate_cells = lambda *a, **k: None
            ref = dilate_cells_host(gh, counts=counts, dense_lut=False)
        finally:
            native.dilate_cells = saved
        u = gh["num_cells"]
        nat = native.dilate_cells(
            gh["cell_ids"][:u].astype(np.int64),
            gh["dims"].astype(np.int64),
            counts[:u],
        )
        assert nat is not None
        d_cells_e, nrows, union = nat
        np.testing.assert_array_equal(d_cells_e, ref["d_cells_e"])
        np.testing.assert_array_equal(nrows, ref["nrows"])
        np.testing.assert_array_equal(union, ref["union"])
