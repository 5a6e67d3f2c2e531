"""The port's prefetching loader (hslam_tpu_torch/io/native_loader.py, a pool of
Python threads) against cv2 and the JAX package's correction functions
(hslam_tpu/ops/undistort.py: photometric_correct, then remap_image), which
the JAX package's C++ loader is held to in tests/test_native_loader.py at
the same tolerance. These need no native build; one case compares with the
JAX package's C++ loader where its library is built (decoding bit for bit,
the correction within that tolerance)."""
import os
import sys
import threading
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslam_tpu.io import native_loader as jnative
from hslam_tpu.ops.undistort import photometric_correct as jcorrect
from hslam_tpu.ops.undistort import remap_image as jremap
from hslam_tpu_torch.io import native_loader as NL

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)

H, W = 48, 64
N = 12
RTOL, ATOL = 1e-5, 1e-3      # tests/test_native_loader.py:117,150


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """N random 48x64 PNGs in a directory and the same files in a zip."""
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.RandomState(0)
    paths = []
    for i in range(N):
        p = str(d / f"{i:05d}.png")
        cv2.imwrite(p, rng.randint(0, 256, (H, W), np.uint8))
        paths.append(p)
    zpath = str(d / "images.zip")
    with zipfile.ZipFile(zpath, "w") as z:
        for p in paths:
            z.write(p, "images/" + os.path.basename(p))
    return paths, zpath


def _tables(out_h=H - 6, out_w=W + 4, seed=5):
    """An inverse response, an inverse vignette at the raw size and a remap
    table of another size, with a block of invalid (-1) entries."""
    rng = np.random.RandomState(seed)
    lut = (np.linspace(0, 255, 256) ** 1.1 / 255.0 ** 0.1).astype(np.float32)
    vig = (1.0 + 0.3 * np.linspace(0, 1, H)[:, None] * np.linspace(0.5, 1, W)[None]
           ).astype(np.float32)
    mx = rng.uniform(-3.0, W + 2.0, (out_h, out_w)).astype(np.float32)
    my = rng.uniform(-3.0, H + 2.0, (out_h, out_w)).astype(np.float32)
    mx[:5, :7] = -1.0
    return lut, vig, np.stack([mx, my], -1)


_jax_correct = jax.jit(lambda im, lut, vig, remap: jremap(jcorrect(im, lut, vig), remap))


def _open(kind, pngs, **kw):
    paths, zpath = pngs
    if kind == "dir":
        return NL.NativeLoader(paths, **kw), None
    zf = zipfile.ZipFile(zpath)
    names = sorted(n for n in zf.namelist() if n.endswith(".png"))
    return NL.NativeMemLoader(len(names), lambda i: zf.read(names[i]), **kw), zf


def _close(ld, zf):
    ld.close()
    if zf is not None:
        zf.close()


def _raw(pngs, i):
    return cv2.imread(pngs[0][i], cv2.IMREAD_GRAYSCALE).astype(np.float32)


@pytest.mark.parametrize("kind", ["dir", "zip"])
def test_decode_equals_cv2_imread(kind, pngs):
    ld, zf = _open(kind, pngs, n_prefetch=4, n_threads=2)
    try:
        assert len(ld) == N and NL.available()
        for i in range(N):
            got = ld.get(i)
            assert got.dtype == np.float32 and got.shape == (H, W)
            np.testing.assert_array_equal(got, _raw(pngs, i))
    finally:
        _close(ld, zf)


@pytest.mark.parametrize("kind", ["dir", "zip"])
def test_correction_matches_jax_photometric_then_remap(kind, pngs):
    """LUT + vignette at the raw size, then a remap to another size: the
    JAX package's remap_image(photometric_correct(raw)) on the same PNGs."""
    lut, vig, remap = _tables()
    ld, zf = _open(kind, pngs, n_prefetch=3, n_threads=2, inv_response=lut,
                   inv_vignette=vig, remap=remap)
    try:
        for i in range(N):
            got = ld.get(i)
            assert got.shape == remap.shape[:2]
            want = np.asarray(_jax_correct(_raw(pngs, i), lut, vig, remap))
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
            assert (got[:5, :7] == 0).all()
    finally:
        _close(ld, zf)


def test_order_is_photometric_then_geometric(pngs):
    """With a vignette at the raw 48x64 size and a 40x70 output, the
    reversed order cannot even be formed; the loader's frame is the
    correction of the raw frame, resampled, and not the resampled frame
    corrected by a resampled vignette."""
    lut, vig, remap = _tables(40, 70)
    ld = NL.NativeLoader(pngs[0], n_prefetch=2, n_threads=1, inv_response=lut,
                         inv_vignette=vig, remap=remap)
    try:
        got = ld.get(3)
    finally:
        ld.close()
    raw = _raw(pngs, 3)
    np.testing.assert_allclose(got, np.asarray(_jax_correct(raw, lut, vig, remap)),
                               rtol=RTOL, atol=ATOL)
    vig_out = np.asarray(jremap(jnp.asarray(vig), jnp.asarray(remap)))
    wrong = np.asarray(jcorrect(jremap(jnp.asarray(raw), jnp.asarray(remap)),
                                jnp.asarray(lut), jnp.asarray(vig_out)))
    assert np.abs(got - wrong).max() > 1.0


def test_zip_is_read_on_the_consumers_thread_only(pngs):
    readers = set()
    zf = zipfile.ZipFile(pngs[1])
    names = sorted(zf.namelist())

    def read(i):
        readers.add(threading.get_ident())
        return zf.read(names[i])

    ld = NL.NativeMemLoader(N, read, n_prefetch=3, n_threads=3)
    try:
        for i in range(N):
            np.testing.assert_array_equal(ld.get(i), _raw(pngs, i))
    finally:
        ld.close()
        zf.close()
    assert readers == {threading.get_ident()}


@pytest.mark.parametrize("kind", ["dir", "zip"])
def test_out_of_order_and_skipping_get(kind, pngs):
    """Back within the kept frames, then jumps ahead past the prefetch
    window (--realtime skipping), then on to the end."""
    ld, zf = _open(kind, pngs, n_prefetch=2, n_threads=2)
    try:
        for i in (0, 2, 1, 3, 9, 8, 10, 11):
            np.testing.assert_array_equal(ld.get(i), _raw(pngs, i))
        if kind == "zip":
            # consumed and dropped: a blob-fed frame fails fast
            with pytest.raises(IOError):
                ld.get(0)
        else:
            # a path-fed frame is decoded again
            np.testing.assert_array_equal(ld.get(0), _raw(pngs, 0))
    finally:
        _close(ld, zf)


def test_prefetch_runs_ahead_of_the_consumer(pngs):
    ld = NL.NativeLoader(pngs[0], n_prefetch=5, n_threads=2)
    pool = ld._pool
    try:
        ld.get(0)
        with pool._cv:
            assert pool._cv.wait_for(lambda: all(k in pool._cache for k in range(5)),
                                     timeout=30)
        ld.get(6)          # frames more than 2 behind the consumer are dropped
        with pool._cv:
            assert not any(k < 4 for k in pool._cache)
            assert pool._cv.wait_for(lambda: all(k in pool._cache for k in range(6, 11)),
                                     timeout=30)
    finally:
        ld.close()


@pytest.mark.parametrize("kind", ["dir", "zip"])
def test_corrupt_png_raises_ioerror(kind, tmp_path, pngs):
    paths = list(pngs[0][:4])
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n this is not a PNG")
    paths[2] = bad
    if kind == "dir":
        ld = NL.NativeLoader(paths, n_prefetch=4, n_threads=2)
    else:
        blobs = []
        for p in paths:
            with open(p, "rb") as f:
                blobs.append(f.read())
        ld = NL.NativeMemLoader(4, lambda i: blobs[i], n_prefetch=4, n_threads=2)
    try:
        np.testing.assert_array_equal(ld.get(1), _raw(pngs, 1))
        with pytest.raises(IOError, match="frame 2"):
            ld.get(2)
        np.testing.assert_array_equal(ld.get(3), _raw(pngs, 3))
    finally:
        ld.close()


def test_missing_file_and_misfit_vignette_raise_ioerror(tmp_path, pngs):
    ld = NL.NativeLoader([str(tmp_path / "none.png")], n_threads=1)
    try:
        with pytest.raises(IOError):
            ld.get(0)
    finally:
        ld.close()
    ld = NL.NativeLoader(pngs[0], n_threads=1, inv_vignette=np.ones((H + 1, W), np.float32))
    try:
        with pytest.raises(IOError, match="vignette"):
            ld.get(0)
    finally:
        ld.close()
    with pytest.raises(ValueError):
        NL.NativeLoader(pngs[0], inv_response=np.ones(255, np.float32))


@pytest.mark.parametrize("kind", ["dir", "zip"])
def test_close_joins_every_worker(kind, pngs):
    before = set(threading.enumerate())
    ld, zf = _open(kind, pngs, n_prefetch=6, n_threads=4)
    workers = list(ld._pool._workers)
    assert len(workers) == 4 and all(t.is_alive() for t in workers)
    ld.get(0)
    _close(ld, zf)
    assert not any(t.is_alive() for t in workers)
    assert set(threading.enumerate()) <= before
    with pytest.raises(ValueError):
        ld.get(1)


def test_stress_more_workers_than_cores(pngs):
    """16 workers, a 1 us switch interval, random access over many loaders:
    every frame comes back right and no worker outlives its loader."""
    lut, vig, remap = _tables()
    want = [np.asarray(_jax_correct(_raw(pngs, i), lut, vig, remap)) for i in range(N)]
    rng = np.random.RandomState(3)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(4):
            ld = NL.NativeLoader(pngs[0], n_prefetch=6, n_threads=16, inv_response=lut,
                                 inv_vignette=vig, remap=remap)
            try:
                for i in rng.randint(0, N, 30):
                    np.testing.assert_allclose(ld.get(int(i)), want[i], rtol=RTOL, atol=ATOL)
            finally:
                ld.close()
            assert not any(t.is_alive() for t in ld._pool._workers)
    finally:
        sys.setswitchinterval(old)


@pytest.mark.skipif(not jnative.available(),
                    reason="the JAX package's C++ loader (native/build/) is not built")
def test_against_the_jax_cpp_loader(pngs):
    """Decoding alone bit for bit; with the tables within the tolerance of
    tests/test_native_loader.py: loader.cpp sums the remap's four bilinear
    taps in another order than utils/interp.bilinear, which the port's
    loader shares with FrameCorrector (up to 3e-5 apart at these values)."""
    lut, vig, remap = _tables()
    for kw, exact in ((dict(), True),
                      (dict(inv_response=lut, inv_vignette=vig, remap=remap), False)):
        ours = NL.NativeLoader(pngs[0], n_prefetch=4, n_threads=2, **kw)
        theirs = jnative.NativeLoader(pngs[0], n_prefetch=4, n_threads=2, **kw)
        try:
            for i in range(N):
                if exact:
                    np.testing.assert_array_equal(ours.get(i), theirs.get(i))
                else:
                    np.testing.assert_allclose(ours.get(i), theirs.get(i), rtol=RTOL, atol=ATOL)
        finally:
            ours.close()
            theirs.close()
