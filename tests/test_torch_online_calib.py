"""`run_sequence --online-calib` on a dataset from disk: the frames go to the
system remapped but not photometrically corrected (response, vignette and
exposures are the online calibrator's to fit), through the prefetching
loader or, with --no-prefetch, decoded on the calling thread and remapped by
FrameCorrector. Held here on a 24-frame TUM monoVO-layout fixture at 160x128
(FOV lens cropped to 128x96, gamma 0.7 response, vignette, exposures):
  (a) the loader's frames and FrameCorrector's with `photometric=False` are
      the same, and equal the remapped raw frames, not the corrected ones;
  (b) both branches of run_sequence give the same trajectory, no pose is
      lost, and a calibration fit lands;
  (slow) the JAX script's dataset branch with --online-calib on the same
      fixture, and on chip_smoke.py phase 15's TUM fixture, against the
      port's run_sequence with the same flags.
"""
import os
import sys
import zipfile

import numpy as np
import pytest
import torch

from hslam_tpu_torch.config import Config
from hslam_tpu_torch.io import synthetic as syn
from hslam_tpu_torch.io.dataset import DatasetReader
from hslam_tpu_torch.io.trajectory import ate_rmse
from hslam_tpu_torch.ops.undistort import remap_image
from hslam_tpu_torch.tools import run_sequence as RS

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

N_FRAMES = 24
# tests/test_system.py:50-55
CFG_KW = dict(max_frames=6, max_points=512, max_immature=512, max_features=512,
              pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
              desired_point_density=400.0, desired_immature_density=300.0,
              tracker_iters_per_level=(6, 10, 10))
SMALL_TUM_CAMERA = ("FOV 0.535719308086809 0.669566858850269 0.493248545285398 "
                    "0.500408664348414 0.897966326944875\n160 128\ncrop\n128 96\n")
LOADER_RTOL, LOADER_ATOL = 1e-5, 1e-3     # tests/test_native_loader.py:117,150


def _fixture(root, layout="zip"):
    """io/synthetic.write_tum along tests/test_system.py's sweep; with
    layout "dir" the frames are moved out of images.zip into images/."""
    info = syn.write_tum(root, syn.Scene(192, 256, 64.0, n_blobs=64), N_FRAMES,
                         SMALL_TUM_CAMERA, dt=0.1, path=lambda i: syn.sweep_xi(i / 10.0))
    if layout == "dir":
        with zipfile.ZipFile(os.path.join(root, "images.zip")) as zf:
            zf.extractall(root)
        os.remove(os.path.join(root, "images.zip"))
    return info


@pytest.fixture(scope="module")
def tum(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("online_calib") / "seq")
    return root, _fixture(root)


@pytest.mark.parametrize("layout", ["zip", "dir"])
def test_loader_hands_over_remapped_raw_frames(tmp_path, layout):
    root = str(tmp_path / "seq")
    _fixture(root, layout)
    rd = DatasetReader(root)
    assert (rd._zip is None) == (layout == "dir") and len(rd) == N_FRAMES
    assert rd.photometric.gamma is not None and rd.photometric.inv_vignette is not None
    loader = RS.open_loader(rd, photometric=False)
    inline = RS.FrameCorrector(rd, False, "cpu")
    corrected = RS.FrameCorrector(rd, True, "cpu")
    assert inline.inv_resp is None and inline.inv_vig is None
    remap = torch.as_tensor(rd.camera.remap)
    try:
        for i in range(len(rd)):
            raw = torch.from_numpy(rd.get_raw(i).image)
            got = torch.from_numpy(loader.get(i))
            want = inline(raw)
            assert tuple(got.shape) == (96, 128)
            torch.testing.assert_close(got, want, rtol=LOADER_RTOL, atol=LOADER_ATOL)
            torch.testing.assert_close(got, remap_image(raw.to(torch.float32), remap),
                                       rtol=LOADER_RTOL, atol=LOADER_ATOL)
            # the correction would move the frame by levels, not ulps
            assert float((got - corrected(raw)).abs().max()) > 5.0
    finally:
        loader.close()
        rd.close()


def _run(root, out, extra, cfg=None):
    args = RS.parse_args(["--dataset", root, "--out", out, "--online-calib",
                          "--device", "cpu"] + extra)
    res = RS.run(args, cfg)
    res.system.close()
    return res


def test_run_sequence_online_calib_both_branches(tum, tmp_path):
    """Through the loader and with --no-prefetch: the same shells, bit for
    bit; every pose valid, a fit landed and switched the correction on."""
    root, _ = tum
    runs = [_run(root, str(tmp_path / f"traj{k}.txt"), extra, Config(**CFG_KW))
            for k, extra in enumerate(([], ["--no-prefetch"]))]
    a, b = (r.system for r in runs)
    for s in (a, b):
        assert s.online_photo_calib and s.initialized and not s.is_lost
        assert all(sh.pose_valid for sh in s.shells) and len(s.shells) == N_FRAMES
        assert s.n_photo_fits >= 1 and s._pc_luts is not None
    assert runs[0].times.wait and not runs[0].times.decode
    assert runs[1].times.decode and not runs[1].times.wait
    assert [sh.id for sh in a.shells if sh.is_kf] == [sh.id for sh in b.shells if sh.is_kf]
    assert a.n_photo_fits == b.n_photo_fits
    for x, y in zip(a.shells, b.shells):
        np.testing.assert_array_equal(x.cam_to_world, y.cam_to_world)
    assert all(torch.equal(u, v) for u, v in zip(a._pc_luts, b._pc_luts))


def _jax_script(root, out, monkeypatch, cfg_kw=None):
    """scripts/run_sequence.py's main on the dataset with --online-calib
    (and --loop-closure, which its dataset branch ignores: C18), its
    dataset branch's Config() made Config(**cfg_kw) when given; returns its
    system and whether it read through the native loader."""
    import run_sequence as JRS

    from hslam_tpu import config as jconfig
    from hslam_tpu.io import native_loader
    from hslam_tpu.models import system as jsystem
    made = []
    if cfg_kw is not None:
        cls = jconfig.Config
        monkeypatch.setattr(jconfig, "Config", lambda **kw: cls(**{**cfg_kw, **kw}))

    class Recorded(jsystem.SLAMSystem):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(jsystem, "SLAMSystem", Recorded)
    monkeypatch.setattr(sys, "argv", ["run_sequence.py", "--dataset", root, "--out", out,
                                      "--online-calib", "--loop-closure"])
    try:
        JRS.main()
    finally:
        for s in made:
            s.close()
    return made[0], native_loader.available()


def _outcome(slam, info):
    """Valid poses, keyframes, ATE over the valid poses, the keyframed
    frames, whether a fit landed, and the fitted response's RMS error
    against the fixture's gamma 0.7 over 256 levels (None without a fit)."""
    if isinstance(slam, RS.SLAMSystem):
        from hslam_tpu_torch.models.photo_calib import gamma_lut
    else:
        from hslam_tpu.models.photo_calib import gamma_lut
    centres = np.array([c for _, c in info["poses"]])
    valid = [s.id for s in slam.shells if s.pose_valid]
    est = np.array([slam.shells[i].cam_to_world[:3, 3] for i in valid])
    err = None
    if slam._pc_params is not None:
        lut = gamma_lut(slam._pc_params)
        lut = np.asarray(lut.cpu() if isinstance(lut, torch.Tensor) else lut, np.float64)
        x = np.arange(256.0)
        err = float(np.sqrt(np.mean((lut - 255.0 * (x / 255.0) ** 0.7) ** 2)))
    return dict(valid=len(valid), keyframes=slam.next_kf_id, ate=float(ate_rmse(centres[valid], est)),
                kf_frames=[s.id for s in slam.shells if s.is_kf],
                fitted=slam._pc_params is not None, response_err=err)


@pytest.fixture(scope="module")
def tum_sensor(tmp_path_factory):
    """chip_smoke.py phase 15's TUM monoVO fixture (1280x1024 FOV, cropped
    to 640x480, 60 frames)."""
    root = str(tmp_path_factory.mktemp("online_calib_sensor") / "tum")
    return root, syn.write_tum(root, syn.Scene(**syn.DATASET_SCENE), syn.DATASET_FRAMES)


@pytest.mark.slow
@pytest.mark.parametrize("size", ["small", "sensor"])
def test_online_calib_dataset_branch_against_the_jax_script(size, request, tmp_path,
                                                            monkeypatch):
    """Both scripts with the same flags (loop closure on, as the JAX branch
    has it) on the 24-frame fixture above, with the small Config above in
    both (the branch's Config() does not initialize at 128x96 in 24
    frames) and the port drawing the JAX package's random numbers (C3: the
    raw frames' bootstrap moves with the draws), and on chip_smoke.py phase
    15's TUM fixture with the branch's Config(): the port's valid poses
    equal the JAX script's, its keyframes within 1, its ATE within PERF.md's
    bar (1.5x the JAX ATE, or 0.02), a fit where the JAX script fitted (at
    the sensor's size both do). There the JAX outcome is
    chip_smoke.JAX_CPU_DATASET["tum_online"]."""
    from test_torch_tools import _jax_draws
    small = size == "small"
    root, info = request.getfixturevalue("tum" if small else "tum_sensor")
    jax_slam, native = _jax_script(root, str(tmp_path / "jax.txt"), monkeypatch,
                                   CFG_KW if small else None)
    j = _outcome(jax_slam, info)
    print(f"JAX run_sequence --online-calib, {size} ({'native loader' if native else 'jnp path'})"
          f": {j}")
    if small:
        _jax_draws(monkeypatch)
    else:
        import chip_smoke
        ref = chip_smoke.JAX_CPU_DATASET["tum_online"]
        assert info["sha256"] == chip_smoke.JAX_CPU_DATASET["tum"]["sha256"] and j["fitted"]
        assert j["kf_frames"] == ref["kf_frames"] and abs(j["ate"] - ref["ate"]) <= 1e-6
    for extra in ([], ["--no-prefetch"]):
        res = _run(root, str(tmp_path / "port.txt"), ["--loop-closure"] + extra,
                   Config(**CFG_KW) if small else None)
        p = _outcome(res.system, info)
        print(f"port run_sequence --online-calib, {size} {' '.join(extra)}: {p}, fits "
              f"{res.system.n_photo_fits}")
        assert p["valid"] == j["valid"]
        assert abs(p["keyframes"] - j["keyframes"]) <= 1
        assert p["ate"] <= max(1.5 * j["ate"], 0.02), (p["ate"], j["ate"])
        assert p["fitted"] or not j["fitted"]
