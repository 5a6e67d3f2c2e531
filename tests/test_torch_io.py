"""The port's dataset input/output against the JAX package on the same files:
calib_io (five lens models x three output modes, the two file formats,
stereo rectification), the DatasetReader over the TUM, EuRoC and KITTI
layouts (zipped and as directories), the TUM trajectory files and ATE, and
utils/robust. calib_io and dataset are numpy copies, so their outputs are
held bit for bit."""
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslam_tpu.io import calib_io as jcal
from hslam_tpu.io import dataset as jds
from hslam_tpu.io import trajectory as jtraj
from hslam_tpu.utils import robust as jrob
from hslam_tpu_torch.io import calib_io as tcal
from hslam_tpu_torch.io import dataset as tds
from hslam_tpu_torch.io import trajectory as ttraj
from hslam_tpu_torch.io.synthetic import se3_exp_np
from hslam_tpu_torch.utils import robust as trob

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)

# [fx, fy, cx, cy, distortion...] per model, absolute, for a 160x120 sensor
MODELS = {
    "pinhole": [110.0, 108.0, 79.3, 60.2],
    "radtan": [96.0, 95.5, 77.0, 58.5, -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05],
    "atan": [85.7, 80.3, 78.4, 59.6, 0.897966326944875],
    "equidistant": [70.0, 70.2, 80.1, 59.9, -0.01, 0.02, -0.005, 0.001],
    "kannalabrandt": [72.0, 71.5, 79.6, 60.4, 0.03, -0.01, 0.004, -0.001],
}
OUT_K = np.array([[60.0, 0, 63.5], [0, 60.0, 47.5], [0, 0, 1.0]])


def _same_camera(a, b):
    assert (a.model, a.in_size, a.out_size) == (b.model, b.in_size, b.out_size)
    for f in ("params", "out_K", "remap", "valid"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("mode", ["crop", "none", "useK"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_make_camera_matches_jax_bit_for_bit(model, mode):
    kw = dict(out_K=OUT_K) if mode == "useK" else {}
    a = tcal.make_camera(model, MODELS[model], (160, 120), (128, 96), mode, **kw)
    b = jcal.make_camera(model, MODELS[model], (160, 120), (128, 96), mode, **kw)
    _same_camera(a, b)
    assert a.valid.any()
    if mode == "crop":       # crop: every output pixel maps inside the input
        assert a.valid[0].all() and a.valid[-1].all()


CAMERA_TXT = {
    "named_radtan_crop": "RadTan 458.654 457.296 367.215 248.375 -0.28340811 0.07395907 "
                         "0.00019359 1.76187114e-05\n752 480\ncrop\n320 240\n",
    "fov_normalized_none": "0.535719 0.669567 0.493249 0.500409 0.897966\n320 256\nnone\n",
    "eight_values_full": "200 199 160.5 120.2 -0.2 0.05 0.001 -0.0005\n320 240\nfull\n320 240\n",
    "four_values_fixed_K": "0.6 0.8 0.5 0.5\n320 240\n0.5 0.66 0.5 0.5 0\n256 192\n",
    "named_kb_crop": "KannalaBrandt 190 190 160 120 0.02 -0.01 0.003 -0.001\n320 240\ncrop\n256 192\n",
}


@pytest.mark.parametrize("name", sorted(CAMERA_TXT))
def test_parse_camera_txt_matches_jax(name, tmp_path):
    p = tmp_path / "camera.txt"
    p.write_text(CAMERA_TXT[name])
    _same_camera(tcal.parse_camera_txt(str(p)), jcal.parse_camera_txt(str(p)))


EUROC_YAML = """%YAML:1.0
image_width: 320
image_height: 240
camera_matrix: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [ 229.3, 0., 183.6, 0., 228.6, 124.2, 0., 0., 1. ]
distortion_model: {model}
distortion_coefficients: !!opencv-matrix
   rows: 1
   cols: 4
   dt: d
   data: [ -0.2834, 0.0739, 0.0002, 0.00002 ]
"""


@pytest.mark.parametrize("model", ["plumb_bob", "fisheye"])
def test_parse_opencv_yaml_matches_jax(model, tmp_path):
    pytest.importorskip("yaml")
    p = tmp_path / "camera.yaml"
    p.write_text(EUROC_YAML.format(model=model))
    a = tcal.parse_opencv_yaml(str(p), out_size=(256, 192))
    _same_camera(a, jcal.parse_opencv_yaml(str(p), out_size=(256, 192)))
    assert a.model == {"plumb_bob": "radtan", "fisheye": "equidistant"}[model]


def test_stereo_rectify_rows_align_and_match_jax():
    """tests/test_dataset.py::test_stereo_rectify_rows_align on the port's
    copy: corresponding points land on one rectified row, disparity is
    f B / Z, and each rectified pixel's table entry is the ray's distorted
    source pixel; every output equals the JAX package's."""
    from scipy.spatial.transform import Rotation as Rot

    rng = np.random.RandomState(0)
    p1 = np.array([300.0, 300.0, 320.0, 240.0, -0.28, 0.07, 1e-4, -2e-4])
    p2 = np.array([305.0, 304.0, 318.0, 242.0, -0.27, 0.06, -1e-4, 5e-5])
    R = Rot.from_rotvec([0.004, -0.01, 0.002]).as_matrix()
    T = -R @ np.array([0.11, 0.002, -0.001])
    out = tcal.stereo_rectify("radtan", p1, "radtan", p2, (640, 480), R, T)
    ref = jcal.stereo_rectify("radtan", p1, "radtan", p2, (640, 480), R, T)
    _same_camera(out[0], ref[0])
    _same_camera(out[1], ref[1])
    for x, y in zip(out[2:], ref[2:]):
        np.testing.assert_array_equal(x, y)
    cam1, _, R1, R2, P1, P2 = out

    X = np.stack([rng.uniform(-0.5, 0.5, 40), rng.uniform(-0.4, 0.4, 40),
                  rng.uniform(1.0, 4.0, 40)], -1)
    xr1 = X @ R1.T
    xr2 = (X @ R.T + T) @ R2.T
    u1 = P1[0, 0] * xr1[:, 0] / xr1[:, 2] + P1[0, 2]
    v1 = P1[1, 1] * xr1[:, 1] / xr1[:, 2] + P1[1, 2]
    u2 = P2[0, 0] * xr2[:, 0] / xr2[:, 2] + P2[0, 2]
    v2 = P2[1, 1] * xr2[:, 1] / xr2[:, 2] + P2[1, 2]
    np.testing.assert_allclose(v1, v2, atol=1e-8)
    np.testing.assert_allclose(u1 - u2, -P2[0, 3] / xr1[:, 2], rtol=1e-6)
    xd, yd = tcal._distort("radtan", p1[4:], X[:, 0] / X[:, 2], X[:, 1] / X[:, 2])
    ud, vd = p1[0] * xd + p1[2], p1[1] * yd + p1[3]
    inside = (u1 > 1) & (u1 < 638) & (v1 > 1) & (v1 < 478)
    checked = 0
    for ui, vi, udi, vdi in zip(u1[inside], v1[inside], ud[inside], vd[inside]):
        x0, y0 = int(ui), int(vi)
        fx_, fy_ = ui - x0, vi - y0
        patch = cam1.remap[y0:y0 + 2, x0:x0 + 2]
        if (patch < 0).any():
            continue
        interp = (patch[0, 0] * (1 - fx_) * (1 - fy_) + patch[0, 1] * fx_ * (1 - fy_)
                  + patch[1, 0] * (1 - fx_) * fy_ + patch[1, 1] * fx_ * fy_)
        assert abs(interp[0] - udi) < 0.05 and abs(interp[1] - vdi) < 0.05
        checked += 1
    assert checked > 20


# ------------------------------------------------------------ DatasetReader
def _png(seed, h=24, w=32):
    img = np.random.RandomState(seed).randint(0, 256, (h, w), np.uint8)
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return buf.tobytes()


def _write_layout(root, kind, zipped, n=4):
    """A sequence of `n` random 32x24 PNGs in one of the reader's layouts,
    with a pinhole camera.txt; TUM gets times.txt with exposures, a
    pcalib.txt and a 16-bit vignette.png; KITTI a times.txt."""
    os.makedirs(root)
    names = {
        "tum": [f"images/{i:05d}.png" for i in range(n)],
        "euroc": [f"mav0/cam0/data/{1403636579763555584 + 50_000_000 * i}.png"
                  for i in range(n)],
        "kitti": [f"image_0/{i:06d}.png" for i in range(n)],
    }[kind]
    if zipped:
        with zipfile.ZipFile(os.path.join(root, "images.zip"), "w") as z:
            for i, name in enumerate(names):
                z.writestr(name, _png(i))
    else:
        for i, name in enumerate(names):
            os.makedirs(os.path.join(root, os.path.dirname(name)), exist_ok=True)
            with open(os.path.join(root, name), "wb") as f:
                f.write(_png(i))
        if kind == "euroc":
            with open(os.path.join(root, "mav0", "cam0", "data.csv"), "w") as f:
                f.write("#timestamp [ns],filename\n")
                for name in names:
                    base = os.path.basename(name)
                    f.write(f"{base[:-4]},{base}\n")
    if kind == "tum":
        with open(os.path.join(root, "times.txt"), "w") as f:
            for i in range(n):
                f.write(f"{i:05d} {i * 0.05:.6f} {1.0 + 0.1 * i:.3f}\n")
        with open(os.path.join(root, "pcalib.txt"), "w") as f:
            f.write(" ".join(str(2.0 * 255.0 * (x / 255.0) ** 0.7) for x in range(256)))
        yy, xx = np.mgrid[0:24, 0:32]
        vig = 60000.0 * (1.0 - 0.4 * ((xx - 15.5) ** 2 + (yy - 11.5) ** 2) / 400.0)
        cv2.imwrite(os.path.join(root, "vignette.png"), vig.astype(np.uint16))
    if kind == "kitti":
        with open(os.path.join(root, "times.txt"), "w") as f:
            f.writelines(f"{i * 0.1:.6f}\n" for i in range(n))
    with open(os.path.join(root, "camera.txt"), "w") as f:
        f.write("30 30 15.5 11.5 0\n32 24\nnone\n32 24\n")
    return root


@pytest.mark.parametrize("zipped", [True, False], ids=["zip", "dir"])
@pytest.mark.parametrize("kind", ["tum", "euroc", "kitti"])
def test_dataset_reader_matches_jax(kind, zipped, tmp_path):
    root = _write_layout(str(tmp_path / "seq"), kind, zipped)
    # a zipped EuRoC or KITTI sequence has no directory to detect it by
    given = kind if zipped else None
    a, b = tds.DatasetReader(root, given), jds.DatasetReader(root, given)
    try:
        assert a.kind == b.kind == kind
        assert a.files == b.files and len(a) == len(b) == 4
        assert a.timestamps == b.timestamps and a.exposures == b.exposures
        _same_camera(a.camera, b.camera)
        for f in ("gamma", "inv_vignette"):
            x, y = getattr(a.photometric, f), getattr(b.photometric, f)
            assert (x is None) == (y is None) == (kind != "tum"), f
            if x is not None:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
        for i in range(len(a)):
            fa, fb = a.get_raw(i), b.get_raw(i)
            assert fa.image.dtype == fb.image.dtype == np.float32
            np.testing.assert_array_equal(fa.image, fb.image)
            assert (fa.timestamp, fa.exposure, fa.id) == (fb.timestamp, fb.exposure, fb.id)
    finally:
        a.close()
    if kind == "tum":
        assert a.photometric.gamma[-1] == 255.0        # pcalib normalized to 0..255


# ------------------------------------------------------------ trajectories
def _poses(n=25, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        R, t = se3_exp_np(rng.normal(size=6) * np.array([0.5, 0.5, 0.5, 1.2, 1.2, 1.2]))
        out.append((R, t))
    # the branches of rot_to_quat: trace-dominant and each diagonal-dominant
    for ax in range(3):
        w = np.zeros(3)
        w[ax] = 3.0
        out.append((se3_exp_np(np.r_[np.zeros(3), w])[0], np.zeros(3)))
    return out


def test_write_tum_byte_identical_and_readers_match(tmp_path):
    poses = _poses()
    ts = [1403636579.763555584 + 0.05 * i for i in range(len(poses))]
    a, b = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    ttraj.write_tum(a, ts, poses)
    jtraj.write_tum(b, ts, poses)
    assert open(a, "rb").read() == open(b, "rb").read()
    for x, y in zip(ttraj.read_tum(a), jtraj.read_tum(a)):
        np.testing.assert_array_equal(x, y)
    q = ttraj.read_tum(a)[2]
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-6)


def test_associate_and_evaluate_ate_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    n = 40
    ts_g = np.arange(n) * 0.05
    ts_e = np.sort(ts_g[rng.permutation(n)[:30]] + rng.uniform(-0.015, 0.015, 30))
    assert ttraj.associate(ts_g, ts_e) == jtraj.associate(ts_g, ts_e)
    assert ttraj.associate(ts_g, ts_e, 0.005) == jtraj.associate(ts_g, ts_e, 0.005)
    gt = [(np.eye(3), np.array([np.sin(0.1 * i), 0.02 * i, np.cos(0.1 * i)])) for i in range(n)]
    # a scaled, rotated and noisy estimate (monocular: Sim3 alignment)
    Rz = se3_exp_np(np.array([0, 0, 0, 0, 0, 0.3]))[0]
    est = [(np.eye(3), 2.5 * Rz @ c + 0.01 * rng.normal(size=3) + 1.0) for _, c in gt]
    g, e = str(tmp_path / "gt.txt"), str(tmp_path / "est.txt")
    ttraj.write_tum(g, ts_g, gt)
    ttraj.write_tum(e, ts_g + 0.004, est)
    ate = ttraj.evaluate_ate(g, e)
    assert ate == jtraj.evaluate_ate(g, e)
    assert 0 < ate < 0.02
    assert np.isnan(ttraj.evaluate_ate(g, e, max_diff=0.001))


# ------------------------------------------------------------ robust
@pytest.mark.parametrize("fn", ["huber_weight", "huber_energy", "huber_irls_weight"])
def test_robust_matches_jax(fn):
    rng = np.random.default_rng(1)
    r = np.concatenate([rng.normal(0, 12, 500), [0.0, 9.0, -9.0, 1e-14]]).astype(np.float32)
    a = getattr(trob, fn)(torch.from_numpy(r), 9.0).numpy()
    b = np.asarray(jax.jit(lambda x: getattr(jrob, fn)(x, 9.0))(jnp.asarray(r)))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_gradient_weight_matches_jax():
    rng = np.random.default_rng(2)
    gx, gy = rng.normal(0, 40, (2, 300)).astype(np.float32)
    a = trob.gradient_weight(torch.from_numpy(gx), torch.from_numpy(gy), 50.0).numpy()
    b = np.asarray(jax.jit(lambda x, y: jrob.gradient_weight(x, y, 50.0))(gx, gy))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
