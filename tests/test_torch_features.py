"""The indirect frontend of hslam_tpu_torch (ops/orb.py, ops/features.py,
the blur of ops/pyramid.py) against the JAX package, from the same numpy
images: FAST exactly, NMS keypoint sets, orientation, descriptors and
Hamming distances bit for bit, the feature-pyramid resize, the whole
multi-scale extraction, sub-pixel refinement, radius queries, matching,
and the descriptor layout through convert.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslam_tpu.ops import features as jft
from hslam_tpu.ops import orb as jorb
from hslam_tpu.ops.pyramid import gaussian_blur7 as jblur
from hslam_tpu_torch.convert import from_numpy, to_numpy
from hslam_tpu_torch.io.synthetic import Scene
from hslam_tpu_torch.ops import features as tft
from hslam_tpu_torch.ops import orb as torb
from hslam_tpu_torch.ops.pyramid import gaussian_blur7 as tblur

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _n(x):
    return np.asarray(x)


def _img(h, w, seed=11):
    """A rendered frame of the synthetic scene, quantized like a sensor."""
    img = Scene(h, w, w / 2, seed=seed, n_blobs=16 if h < 200 else 400).render(
        np.eye(3), np.zeros(3))
    return np.round(img).astype(np.float32)


@pytest.fixture(scope="module")
def small():
    return _img(96, 128)


@pytest.fixture(scope="module")
def keypoints(small):
    """FAST + NMS keypoints of the small frame (from the JAX package)."""
    score = jorb.fast_score(jnp.asarray(small), 8.0)
    u, v, valid = jorb.grid_nms(score, 8, 96)
    return _n(u), _n(v), _n(valid)


def test_fast_score_exact(small):
    j = _n(jorb.fast_score(jnp.asarray(small), 8.0))
    t = torb.fast_score(_t(small), 8.0).numpy()
    assert (j > 0).sum() > 100
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("cell,capacity", [(8, 96), (4, 2000)])
def test_grid_nms_sets(small, cell, capacity):
    score = _n(jorb.fast_score(jnp.asarray(small), 8.0))
    ju, jv, jval = (_n(x) for x in jorb.grid_nms(jnp.asarray(score), cell, capacity))
    tu, tv, tval = (x.numpy() for x in torb.grid_nms(_t(score), cell, capacity))
    assert jval.sum() > 20
    # as sets of (u, v) among the valid keypoints (C4) ...
    assert set(zip(tu[tval], tv[tval])) == set(zip(ju[jval], jv[jval]))
    # ... and, with ties in index order on both sides, even slot by slot
    np.testing.assert_array_equal(tval, jval)
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(tv, jv)


def test_ic_angle(small, keypoints):
    u, v, _ = keypoints
    j = _n(jorb.ic_angle(jnp.asarray(small), jnp.asarray(u), jnp.asarray(v)))
    t = torb.ic_angle(_t(small), _t(u), _t(v)).numpy()
    # moments summed over 709 taps in another order: f32 angle agreement
    np.testing.assert_allclose(t, j, atol=1e-5)


def test_brief_pattern_copied():
    np.testing.assert_array_equal(torb._PATTERN256, jorb._PATTERN256)
    np.testing.assert_array_equal(tft._IDX_TABLES, jft._IDX_TABLES)


def test_rbrief_bit_exact(small, keypoints):
    u, v, _ = keypoints
    blur = _n(jblur(jnp.asarray(small)))
    ang = _n(jorb.ic_angle(jnp.asarray(small), jnp.asarray(u), jnp.asarray(v)))
    j = _n(jorb.rbrief(jnp.asarray(blur), jnp.asarray(u), jnp.asarray(v), jnp.asarray(ang)))
    t = torb.rbrief(_t(blur), _t(u), _t(v), _t(ang)).numpy()
    np.testing.assert_array_equal(t.view(np.uint32), j)


def test_gaussian_blur7(small):
    j = _n(jblur(jnp.asarray(small)))
    t = tblur(_t(small)).numpy()
    # 7-tap separable sums of values up to 255: a few f32 ulps
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-4)


def test_describe_bit_exact(small, keypoints):
    u, v, _ = keypoints
    blur = _n(jblur(jnp.asarray(small)))
    jd, ja = jft.describe(jnp.asarray(blur), jnp.asarray(u), jnp.asarray(v))
    td, ta = tft.describe(_t(blur), _t(u), _t(v))
    # the moments cancel over ~700 taps of up to 255 x 15, summed in another
    # order: the angle agrees to ~1e-4 rad, far inside its 0.39 rad bins
    np.testing.assert_allclose(ta.numpy(), _n(ja), atol=2e-4)
    np.testing.assert_array_equal(td.numpy().view(np.uint32), _n(jd))


def test_hamming_and_matching_exact(small, keypoints):
    u, v, valid = keypoints
    blur = jblur(jnp.asarray(small))
    d1, _ = jft.describe(blur, jnp.asarray(u), jnp.asarray(v))
    d2, _ = jft.describe(blur, jnp.asarray(u + 1.0), jnp.asarray(v))
    d1n, d2n = _n(d1), _n(d2)
    jD = _n(jorb.hamming_matrix(d1, d2))
    tD = torb.hamming_matrix(_t(d1n.view(np.int32)), _t(d2n.view(np.int32))).numpy()
    np.testing.assert_array_equal(tD, jD)
    # an f64-free oracle: unpacked bits
    bits = lambda d: np.unpackbits(d.view(np.uint8), axis=-1)  # noqa: E731
    np.testing.assert_array_equal(
        (bits(d1n)[:, None, :] != bits(d2n)[None, :, :]).sum(-1), tD)
    vb = valid.copy()
    vb[::7] = False
    ji, jok = jorb.match_descriptors(d1, d2, valid_a=jnp.asarray(valid), valid_b=jnp.asarray(vb))
    ti, tok = torb.match_descriptors(_t(d1n.view(np.int32)), _t(d2n.view(np.int32)),
                                     valid_a=_t(valid), valid_b=_t(vb))
    np.testing.assert_array_equal(tok.numpy(), _n(jok))
    np.testing.assert_array_equal(ti.numpy()[_n(jok)], _n(ji)[_n(jok)])
    assert _n(jok).sum() > 10
    mi, mok = jft.match_pair(d1, jnp.asarray(valid), d2, jnp.asarray(vb))
    ti, tok = tft.match_pair(_t(d1n.view(np.int32)), _t(valid), _t(d2n.view(np.int32)), _t(vb))
    np.testing.assert_array_equal(tok.numpy(), _n(mok))
    np.testing.assert_array_equal(ti.numpy(), _n(mi))


@pytest.mark.parametrize("hw", [(96, 128), (480, 640)], ids=["96x128", "480x640"])
def test_level_resize_matches_jax_image_resize(hw):
    img = _img(*hw)
    H, W = hw
    for lv in range(1, 4):
        hl = max(int(round(H / 1.2 ** lv)), 34)
        wl = max(int(round(W / 1.2 ** lv)), 34)
        j = _n(jax.image.resize(jnp.asarray(img), (hl, wl), method="bilinear"))
        t = tft.level_image(_t(img), lv, 1.2).numpy()
        assert t.shape == j.shape
        # Same antialiased weights, contracted in another order. Values reach
        # 255, where an f32 ulp is 1.5e-5: the JAX result itself is up to
        # 3e-4 from an f64 product of the same weights (measured at 480x640),
        # so 1e-4 absolute is below what f32 can resolve; 1e-3 is 4e-6 of
        # the range.
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-3)


def _jax_extract(img, n_levels, capacity, fast_th, **kw):
    """The JAX package's extraction inside one jit, as its kf_step runs it
    (op-by-op dispatch would compile each op apart, ~10x slower here)."""
    fn = jax.jit(functools.partial(jft.extract_multiscale, n_levels=n_levels,
                                   capacity=capacity, fast_th=fast_th, **kw))
    return jax.device_get(fn(jnp.asarray(img)))


@pytest.mark.parametrize("fast_only", [False, True], ids=["gradient_union", "fast_only"])
def test_extract_multiscale(small, fast_only):
    args = (4, 256, 8.0)
    J = _jax_extract(small, *args, use_fast_only=fast_only)
    T = to_numpy(tft.extract_multiscale(_t(small), *args, use_fast_only=fast_only))
    ju, jv, jl, jsc, jd, jval = J
    tu, tv, tl, tsc, td, tval = T
    assert jval.sum() > (20 if fast_only else 100)
    key = lambda u, v, l, m: set(zip(u[m], v[m], l[m]))  # noqa: E731
    assert key(tu, tv, tl, tval) == key(ju, jv, jl, jval)
    # slot by slot, and the descriptors bit for bit where keypoints coincide
    np.testing.assert_array_equal(tval, jval)
    same = (tu == ju) & (tv == jv)
    assert same[jval].all()
    np.testing.assert_array_equal(td.view(np.uint32)[same], jd[same])
    # scores at resized levels carry the resize's f32 differences
    np.testing.assert_allclose(tsc, jsc, rtol=1e-5)


def test_extract_multiscale_subpix(small):
    J = _jax_extract(small, 3, 128, 8.0, do_subpix=True)
    T = to_numpy(tft.extract_multiscale(_t(small), 3, 128, 8.0, do_subpix=True))
    np.testing.assert_array_equal(T[5], J[5])
    m = J[5]
    # five 2x2 solves per corner; on this smooth texture some structure
    # tensors are near-singular and amplify f32 ulps (measured: 7 of 128
    # corners differ, by up to 0.03 px); well-conditioned corners agree to
    # 1e-4 (test_subpix_refine)
    np.testing.assert_allclose(T[0][m], J[0][m], atol=0.1)
    np.testing.assert_allclose(T[1][m], J[1][m], atol=0.1)
    assert (np.abs(T[0][m] - J[0][m]) < 1e-4).mean() > 0.9


def test_subpix_refine():
    """Blurred checker corners at known fractional positions (the image of
    tests/test_features.py::TestSubpix, tiled), refined from their integer
    locations in both packages."""
    import scipy.ndimage as ndi
    ys, xs = np.mgrid[0:64, 0:160].astype(np.float64)
    img = np.zeros_like(xs)
    truth = [(20.37, 30.72), (60.61, 25.18), (100.12, 36.43), (140.83, 29.55)]
    for k, (cx, cy) in enumerate(truth):
        sl = (xs >= 40 * k) & (xs < 40 * k + 40)
        img[sl] = (200.0 * ((xs < cx) ^ (ys < cy)) + 20.0)[sl]
    img = ndi.gaussian_filter(img, 1.2).astype(np.float32)
    u = np.array([round(c[0]) for c in truth], np.float32)
    v = np.array([round(c[1]) for c in truth], np.float32)
    ju, jv = jft.subpix_refine(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v), iters=8)
    tu, tv = tft.subpix_refine(_t(img), _t(u), _t(v), iters=8)
    assert (np.abs(_n(ju) - u) > 0.1).sum() >= 3
    np.testing.assert_allclose(tu.numpy(), _n(ju), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), _n(jv), atol=1e-4)
    # near the truth (the tiles' seams bias the blurred corners slightly)
    err = np.hypot(tu.numpy() - np.array(truth)[:, 0], tv.numpy() - np.array(truth)[:, 1])
    assert err.max() < 0.3, err


def test_features_in_area_exact(small):
    u, v, lvl, _, _, valid = _jax_extract(small, 3, 128, 8.0)
    qu = np.array([30.0, 64.0, 100.0], np.float32)
    qv = np.array([30.0, 48.0, 70.0], np.float32)
    jm = _n(jft.features_in_area(*(jnp.asarray(x) for x in (u, v, valid, lvl, qu, qv)),
                                 20.0, min_level=0, max_level=1))
    tm = tft.features_in_area(*(_t(x) for x in (u, v, valid, lvl, qu, qv)), 20.0,
                              min_level=0, max_level=1).numpy()
    assert jm.sum() > 3
    np.testing.assert_array_equal(tm, jm)


def test_match_pair_across_views():
    """Two renderings of the scene a small motion apart: the port's
    extraction + matching gives the JAX package's matches exactly."""
    sc = Scene(96, 128, 80.0, n_blobs=16)
    a = np.round(sc.render(np.eye(3), np.zeros(3))).astype(np.float32)
    b = np.round(sc.render(np.eye(3), np.array([0.03, 0.01, 0.0]))).astype(np.float32)
    Ja = _jax_extract(a, 4, 256, 8.0)
    Jb = _jax_extract(b, 4, 256, 8.0)
    ji, jok = jft.match_pair(*(jnp.asarray(x) for x in (Ja[4], Ja[5], Jb[4], Jb[5])))
    Ta = tft.extract_multiscale(_t(a), 4, 256, 8.0)
    Tb = tft.extract_multiscale(_t(b), 4, 256, 8.0)
    ti, tok = tft.match_pair(Ta[4], Ta[5], Tb[4], Tb[5])
    assert _n(jok).sum() > 30
    np.testing.assert_array_equal(tok.numpy(), _n(jok))
    np.testing.assert_array_equal(ti.numpy(), _n(ji))
    # batched over a leading slot dimension, as indirect association calls it
    bi, bok = tft.match_pair(torch.stack([Ta[4], Tb[4]]), torch.stack([Ta[5], Tb[5]]),
                             Tb[4], Tb[5])
    np.testing.assert_array_equal(bi[0].numpy(), ti.numpy())
    np.testing.assert_array_equal(bok[0].numpy(), tok.numpy())


def test_feats_convert_round_trip():
    """JAX Feats -> port -> numpy is exact, and Hamming distances survive."""
    rng = np.random.default_rng(0)
    F, NF = 3, 40
    feats = jft.empty_feats(F, NF)
    desc = rng.integers(0, 2 ** 32, (F, NF, 8), dtype=np.uint64).astype(np.uint32)
    feats = feats._replace(
        u=jnp.asarray(rng.uniform(0, 100, (F, NF)), jnp.float32),
        v=jnp.asarray(rng.uniform(0, 80, (F, NF)), jnp.float32),
        level=jnp.asarray(rng.integers(0, 4, (F, NF)), jnp.int32),
        desc=jnp.asarray(desc), valid=jnp.asarray(rng.uniform(size=(F, NF)) > 0.3))
    jn = jax.device_get(feats)
    port = from_numpy(jn, "cpu")
    assert isinstance(port, tft.Feats) and port.desc.dtype == torch.int32
    back = to_numpy(port)
    for name in jn._fields:
        a, b = getattr(back, name), getattr(jn, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    jD = _n(jorb.hamming_matrix(feats.desc[0], feats.desc[1]))
    np.testing.assert_array_equal(torb.hamming_matrix(port.desc[0], port.desc[1]).numpy(), jD)
