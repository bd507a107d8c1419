"""The port's JPEG ingest (flowerdiff_torch/native) against the JAX
package's (flowerdiff/native): the reference's binding is pointed at a
library built here from the same source with tools/build_native.py's flags
(its `_SO_PATH` patched to a temporary file), and the two decodes must be
bit-equal; with both libraries off, the two PIL fallbacks must be
bit-equal; a file that fails to decode is zero and marked not ok on every
path; a build that cannot happen is reported and falls back to PIL. Skips
where this machine has no g++ or no libjpeg headers."""
import shutil
import subprocess

import numpy as np
import pytest
from PIL import Image

import flowerdiff.native as jnative
import flowerdiff_torch.native as native


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    so = tmp_path_factory.mktemp("jax_native") / "libflowerjpeg.so"
    out = subprocess.run(["g++", *native.FLAGS, "-o", str(so), native.SOURCE, *native.LIBS],
                         capture_output=True, text=True, timeout=300)
    if out.returncode:
        pytest.skip(f"the native decoder does not build here: {out.stderr.strip()[:200]}")
    assert native.native_available(), native.build_error()
    return str(so)


@pytest.fixture()
def reference_native(built, monkeypatch):
    monkeypatch.setattr(jnative, "_SO_PATH", built)
    monkeypatch.setattr(jnative, "_lib", None)


@pytest.fixture()
def jpegs(tmp_path):
    """Six JPEGs of other sizes and aspect ratios, and one file that is no
    JPEG (index 3)."""
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        arr = rng.integers(0, 255, (120 + 23 * i, 90 + 17 * i, 3), dtype=np.uint8)
        arr[: 20 + i, :30] = 40 * i
        path = tmp_path / f"img_{i}.jpg"
        Image.fromarray(arr).save(path, quality=90)
        paths.append(str(path))
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    paths.insert(3, str(bad))
    return paths


@pytest.mark.parametrize("size", [32, 64])
def test_native_decode_is_bit_equal_to_the_reference(reference_native, jpegs, size):
    assert jnative.native_available() and native.native_available()
    got, ok = native.decode_jpeg_batch(jpegs, size)
    want, want_ok = jnative.decode_jpeg_batch(jpegs, size)
    assert got.shape == (7, size, size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ok, want_ok)
    assert ok.tolist() == [True] * 3 + [False] + [True] * 3
    assert not got[3].any()


def test_pil_fallbacks_are_bit_equal(monkeypatch, jpegs):
    monkeypatch.setattr(jnative, "_load", lambda: None)
    monkeypatch.setattr(native, "_load", lambda: None)
    got, ok = native.decode_jpeg_batch(jpegs, 48)
    want, want_ok = jnative.decode_jpeg_batch(jpegs, 48)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ok, want_ok)
    assert ok.tolist() == [True] * 3 + [False] + [True] * 3 and not got[3].any()


def test_a_build_that_cannot_happen_is_reported_and_decodes_with_pil(monkeypatch, tmp_path,
                                                                     jpegs):
    monkeypatch.setattr(native, "SOURCE", str(tmp_path / "missing.cpp"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert not native.native_available()
    assert "missing.cpp" in native.build_error()
    got, ok = native.decode_jpeg_batch(jpegs, 32)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    want, _ = jnative.decode_jpeg_batch(jpegs, 32)
    np.testing.assert_array_equal(got, want)
    assert ok.sum() == 6
