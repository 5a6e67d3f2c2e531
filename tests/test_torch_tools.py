"""The port's command-line tools (hslam_tpu_torch/tools) on generated datasets, against
the JAX package where it has a counterpart:

  * eval_baseline.run_config, config 3, on tests/test_eval_baseline.py's
    EuRoC-zip fixture rendered by the port (its assertions);
  * run_sequence on a synthetic sequence and on a dataset with the metrics
    stream, debug PNGs and the live-map server;
  * fault C17 of the JAX eval_baseline (it corrects photometrically after
    the remap): its run_config fails on a TUM monoVO-sized sequence, and the
    port's correction is the reference's order composed from the JAX
    package's own functions;
  * the whole dataset slice (read, correct, remap, the sequential hybrid
    system) through both packages on one fixture: the same keyframes and
    ATE within 10%. On the small fixture of tier 1 the port draws the JAX
    package's random numbers (C3) and is held to the JAX outcome recorded
    below; slow tests rerun the JAX package live, at the small size and at
    the sensor sizes of chip_smoke.py's phase 15, whose JAX figures
    (chip_smoke.JAX_CPU_DATASET) they produce and check.
"""
import os
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslam_tpu.config import Config as JConfig
from hslam_tpu.io.dataset import DatasetReader as JReader
from hslam_tpu.models import system as jsystem
from hslam_tpu.ops.undistort import invert_response as jinvert
from hslam_tpu.ops.undistort import photometric_correct as jcorrect
from hslam_tpu.ops.undistort import remap_image as jremap
from hslam_tpu_torch.config import Config
from hslam_tpu_torch.io import synthetic as syn
from hslam_tpu_torch.io.dataset import DatasetReader
from hslam_tpu_torch.io.trajectory import ate_rmse, read_tum
from hslam_tpu_torch.models.system import SLAMSystem
from hslam_tpu_torch.ops import selector as tsel
from hslam_tpu_torch.ops import twoview as ttv
from hslam_tpu_torch.tools import eval_baseline as EB
from hslam_tpu_torch.tools import run_sequence as RS

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

H, W, FX = 96, 128, 80.0
CX, CY = W / 2 - 0.5, H / 2 - 0.5
# tests/test_system.py:50-55 (tests/test_eval_baseline.py:62-73 for config 3)
CFG_KW = dict(max_frames=6, max_points=512, max_immature=512, max_features=512,
              pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
              desired_point_density=400.0, desired_immature_density=300.0,
              tracker_iters_per_level=(6, 10, 10))


# ------------------------------------------------------------ eval_baseline
def _write_euroc_zip(root, n_frames):
    """tests/test_eval_baseline.py's fixture, rendered by io/synthetic:
    images.zip!mav0/cam0/data/<ts_ns>.png, a pinhole camera.txt and the
    camera centres in mav0/state_groundtruth_estimate0/data.csv."""
    def xi(i):
        t = i / 10.0
        return np.array([0.4 * np.sin(0.3 * t), 0.25 * (1 - np.cos(0.35 * t)),
                         0.12 * np.sin(0.2 * t), 0.03 * np.sin(0.25 * t),
                         0.03 * (1 - np.cos(0.2 * t)), 0.015 * t])

    frames, centres = syn.make_sequence(syn.Scene(H, W, FX, n_blobs=16), n_frames, xi)
    os.makedirs(os.path.join(root, "mav0", "state_groundtruth_estimate0"))
    rows = []
    with zipfile.ZipFile(os.path.join(root, "images.zip"), "w") as zf:
        for i, (img, c) in enumerate(zip(frames, centres)):
            ts_ns = int(i / 10.0 * 1e9)
            zf.writestr(f"mav0/cam0/data/{ts_ns}.png", syn._png(img))
            rows.append(f"{ts_ns},{c[0]},{c[1]},{c[2]},1,0,0,0")
    with open(os.path.join(root, "mav0", "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#timestamp,px,py,pz,qw,qx,qy,qz\n" + "\n".join(rows) + "\n")
    with open(os.path.join(root, "camera.txt"), "w") as f:
        f.write(f"{FX} {FX} {CX} {CY} 0\n{W} {H}\nnone\n{W} {H}\n")
    return root


def test_run_config_full_hybrid_on_euroc_zip(tmp_path):
    root = _write_euroc_zip(str(tmp_path / "seq"), n_frames=36)
    rd = DatasetReader(root, "euroc")
    assert len(rd) == 36 and rd.camera.out_size == (W, H)
    rd.close()
    r = EB.run_config(root, 3, cfg_override=Config(**CFG_KW), device="cpu")
    assert r["initialized"], r
    assert r["n_frames"] == 36 and r["n_valid_poses"] == 36
    assert r["n_keyframes"] >= 3
    assert r["gt_matched_frames"] >= 25
    assert r["ate_rmse"] is not None and r["ate_rmse"] < 0.15, r


# ------------------------------------------------------------ run_sequence
def test_run_sequence_synthetic_writes_tum(tmp_path):
    out = str(tmp_path / "traj.txt")
    res = RS.run(RS.parse_args(["--synthetic", "6", "--out", out, "--device", "cpu"]),
                 Config(**CFG_KW))
    assert not res.system.is_lost and res.n_frames == 6
    ts, pos, quat = read_tum(out)
    np.testing.assert_allclose(ts, np.arange(6) / 30.0, atol=1e-9)
    assert np.isfinite(pos).all() and np.abs(np.linalg.norm(quat, axis=1) - 1).max() < 1e-6


SMALL_TUM_CAMERA = ("FOV 0.535719308086809 0.669566858850269 0.493248545285398 "
                    "0.500408664348414 0.897966326944875\n160 128\ncrop\n128 96\n")


def _small_tum(root, n=20):
    """A TUM monoVO-layout sequence at 160x128 (FOV lens, cropped to
    128x96; gamma 0.7 response, vignette, exposures) along the sweep."""
    return syn.write_tum(root, syn.Scene(192, 256, 64.0, n_blobs=64), n, SMALL_TUM_CAMERA,
                         dt=0.1, path=lambda i: syn.sweep_xi(i / 10.0))


def test_run_sequence_dataset_with_metrics_viz_and_viewer(tmp_path):
    import json
    import urllib.request
    root = str(tmp_path / "seq")
    _small_tum(root, n=10)
    out, metrics, viz = (str(tmp_path / x) for x in ("traj.txt", "m.jsonl", "viz"))
    res = RS.run(RS.parse_args(["--dataset", root, "--out", out, "--metrics", metrics,
                                "--viz-dir", viz, "--view3d", "--view3d-port", "0",
                                "--device", "cpu"]), Config(**CFG_KW))
    try:
        with urllib.request.urlopen(res.viewer.url + "/data?from=0", timeout=30) as r:
            recs = json.loads(r.read())["records"]
    finally:
        res.viewer.stop()
    slam = res.system
    assert slam.initialized and not slam.is_lost and res.n_frames == 10
    assert {r["t"] for r in recs} == {"frame", "kf", "map"}
    assert len(read_tum(out)[0]) == 10
    pngs = sorted(os.listdir(viz))
    assert len(pngs) == sum(s.is_kf for s in slam.shells[1:]) >= 2
    assert cv2.imread(os.path.join(viz, pngs[0])).shape == (96, 128, 3)
    # frames through the prefetching loader: its wait is timed, not the
    # inline decode / correction / round trip
    assert len(res.times.wait) == len(res.times.process) == 10
    assert not (res.times.decode or res.times.correct or res.times.round_trip)


# ------------------------------------------------------------ C17
def test_c17_jax_eval_baseline_fails_on_tum_monovo_sizes(tmp_path, monkeypatch):
    """The JAX run_config remaps a 1280x1024 frame to 640x480 and then
    multiplies it by the 1280x1024 inverse vignette (scripts/
    eval_baseline.py:144-152); the port corrects first."""
    import eval_baseline as JEB
    root = str(tmp_path / "seq")
    syn.write_tum(root, syn.Scene(**syn.DATASET_SCENE), 2)
    made = []

    class Recorded(jsystem.SLAMSystem):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self._precompile_stop = True      # no background compiles
            made.append(self)

    monkeypatch.setattr(jsystem, "SLAMSystem", Recorded)
    try:
        with pytest.raises((TypeError, ValueError), match="(?i)broadcast|shape"):
            JEB.run_config(root, 2)
    finally:
        for s in made:
            s.close()
    r = EB.run_config(root, 2, device="cpu")
    assert r["n_frames"] == 2 and r["n_valid_poses"] == 2


def test_c17_port_corrects_in_the_references_order(tmp_path):
    """Raw and output sizes equal: the port's corrected frame is the JAX
    package's remap_image(photometric_correct(raw)); the JAX eval_baseline's
    order (remap, then correct) puts the vignette on the wrong pixels."""
    root = str(tmp_path / "seq")
    cam = ("RadTan 91.73 91.46 63.2 48.1 -0.28340811 0.07395907 0.00019359 1.76187114e-05"
           "\n128 96\ncrop\n128 96\n")
    syn.write_tum(root, syn.Scene(192, 256, 64.0, n_blobs=64), 3, cam)
    rd, jr = DatasetReader(root), JReader(root)
    corr = RS.FrameCorrector(rd, True, "cpu")
    remap = jnp.asarray(jr.camera.remap)
    ir = jinvert(jnp.asarray(jr.photometric.gamma))
    iv = jnp.asarray(jr.photometric.inv_vignette)
    ref = jax.jit(lambda im: jremap(jcorrect(im, ir, iv), remap))
    jax_order = jax.jit(lambda im: jcorrect(jremap(im, remap), ir, iv))
    for i in range(len(rd)):
        raw = rd.get_raw(i).image
        out = corr(torch.from_numpy(raw)).numpy()
        np.testing.assert_allclose(out, np.asarray(ref(raw)), atol=1e-4)
        assert np.abs(out - np.asarray(jax_order(raw))).max() > 5.0
    rd.close()


# ------------------------------------------------------------ the whole slice
def _jax_draws(monkeypatch):
    """Make the port draw the JAX package's random numbers (C3): the
    selector's block directions and subsampling uniforms, and the two-view
    RANSAC samples, from the same keys as hslam_tpu/ops/selector.py:156-158,
    :217-218 and hslam_tpu/ops/twoview.py:193-195."""
    def direction_draws(Hh, Ww, pot, seed, device):
        blk4 = 4 * pot
        Hp, Wp = -(-Hh // blk4) * blk4, -(-Ww // blk4) * blk4
        out = []
        for salt, blk in enumerate((pot, 2 * pot, 4 * pot)):
            k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), salt), int(seed))
            d = np.asarray(jax.random.randint(k, (Hp // blk, Wp // blk), 0, 16))
            out.append(torch.from_numpy(d.astype(np.int64)).to(device))
        return out

    compact = tsel.compact_selection

    def compact_selection(status, abs_grad0, capacity, want, seed, rand=None):
        k = jax.random.fold_in(jax.random.PRNGKey(17), int(seed))
        rand = torch.from_numpy(np.array(jax.random.uniform(k, (status.numel(),))))
        return compact(status, abs_grad0, capacity, want, seed, rand=rand.to(status.device))

    def ransac_samples(valid, n_iters, seed):
        v = valid.cpu().numpy().astype(np.float32)
        s = jax.random.choice(jax.random.PRNGKey(int(seed)), len(v), shape=(n_iters, 8),
                              p=jnp.asarray(v / max(v.sum(), 1.0)))
        return torch.from_numpy(np.asarray(s).astype(np.int64)).to(valid.device)

    monkeypatch.setattr(tsel, "direction_draws", direction_draws)
    monkeypatch.setattr(tsel, "compact_selection", compact_selection)
    monkeypatch.setattr(ttv, "ransac_samples", ransac_samples)


def _port_sequential(root, cfg, loop_closure=False):
    """The port's dataset path, as run_sequence runs it, on the CPU."""
    rd = DatasetReader(root)
    K, (w, h) = rd.camera.out_K, rd.camera.out_size
    corr = RS.FrameCorrector(rd, True, "cpu")
    slam = SLAMSystem(K[0, 0], K[1, 1], K[0, 2], K[1, 2], w, h, cfg,
                      enable_loop_closure=loop_closure, device="cpu")
    for i in range(len(rd)):
        fr = rd.get_raw(i)
        slam.process_frame(corr(torch.from_numpy(fr.image)).numpy(), fr.timestamp, fr.exposure)
    slam.close()
    rd.close()
    return slam


def _jax_sequential(root, cfg, loop_closure=False):
    """The JAX package's dataset path (scripts/run_sequence.py:182-227 with
    the Python decoder): correct, remap, process_frame."""
    rd = JReader(root)
    K, (w, h) = rd.camera.out_K, rd.camera.out_size
    pc = rd.photometric
    ir = None if pc.gamma is None else jinvert(jnp.asarray(pc.gamma))
    iv = None if pc.inv_vignette is None else jnp.asarray(pc.inv_vignette)
    remap = jnp.asarray(rd.camera.remap)
    prep = jax.jit(lambda im: jremap(jcorrect(im, ir, iv), remap))
    slam = jsystem.SLAMSystem(K[0, 0], K[1, 1], K[0, 2], K[1, 2], w, h, cfg,
                              enable_loop_closure=loop_closure)
    for i in range(len(rd)):
        fr = rd.get_raw(i)
        slam.process_frame(np.asarray(prep(fr.image)), fr.timestamp, fr.exposure)
    slam.close()
    return slam


def _outcome(slam, centres):
    """(keyframed frames, valid poses, Sim3-aligned ATE over valid poses)."""
    valid = [s.id for s in slam.shells if s.pose_valid]
    est = np.array([slam.shells[i].cam_to_world[:3, 3] for i in valid])
    return [s.id for s in slam.shells if s.is_kf], len(valid), ate_rmse(centres[valid], est)


def _same_slice(port, jax_, n):
    """The acceptance of the whole slice: the same keyframed frames, every
    pose valid, ATE within 10% of the JAX package's (or 1e-3)."""
    (kt, vt, at), (kj, vj, aj) = port, jax_
    assert kt == kj, (kt, kj)
    assert vt == vj == n
    assert abs(at - aj) <= max(0.1 * aj, 1e-3), (at, aj)


def _centres(info):
    return np.array([c for _, c in info["poses"]])


# The JAX package's outcome on _small_tum's 20 frames (XLA:CPU), rerun by
# test_small_slice_jax_reference: keyframed frames and the ATE
JAX_SMALL_TUM = dict(kf_frames=[0, 1, 4, 7, 11, 16], ate=0.02005288571119772)


def test_small_slice_matches_jax_outcome(tmp_path, monkeypatch):
    info = _small_tum(str(tmp_path / "seq"))
    _jax_draws(monkeypatch)
    port = _outcome(_port_sequential(str(tmp_path / "seq"), Config(**CFG_KW)), _centres(info))
    _same_slice(port, (JAX_SMALL_TUM["kf_frames"], 20, JAX_SMALL_TUM["ate"]), 20)


@pytest.mark.slow
def test_small_slice_jax_reference(tmp_path, monkeypatch):
    root = str(tmp_path / "seq")
    info = _small_tum(root)
    jax_ = _outcome(_jax_sequential(root, JConfig(**CFG_KW)), _centres(info))
    print(f"JAX small TUM slice: keyframes {jax_[0]} valid {jax_[1]} ATE {jax_[2]!r}")
    assert jax_[0] == JAX_SMALL_TUM["kf_frames"] and jax_[1] == 20
    assert abs(jax_[2] - JAX_SMALL_TUM["ate"]) <= 1e-6
    _jax_draws(monkeypatch)
    _same_slice(_outcome(_port_sequential(root, Config(**CFG_KW)), _centres(info)), jax_, 20)


def _dataset(tmp_path, kind):
    root = str(tmp_path / kind)
    writer = syn.write_euroc if kind == "euroc" else syn.write_tum
    info = writer(root, syn.Scene(**syn.DATASET_SCENE), syn.DATASET_FRAMES)
    return root, info


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["euroc", "tum"])
def test_dataset_slice_matches_jax_at_sensor_size(kind, tmp_path):
    """chip_smoke.py phase 15 (a) and (b) on the CPU: the sequential
    default-config system on the 752x480 EuRoC fixture with loop closure
    (run_sequence --loop-closure) and on the 1280x1024 TUM monoVO fixture
    with its photometric calibration, in both packages (no draws shared:
    at this size the outcomes agree without). The JAX figures are
    chip_smoke.JAX_CPU_DATASET's."""
    import chip_smoke
    root, info = _dataset(tmp_path, kind)
    lc = kind == "euroc"
    ref = chip_smoke.JAX_CPU_DATASET[kind]
    assert info["sha256"] == ref["sha256"]
    jax_ = _outcome(_jax_sequential(root, JConfig(), lc), _centres(info))
    print(f"JAX {kind} sequential: keyframes {jax_[0]} valid {jax_[1]} ATE {jax_[2]!r}")
    port = _outcome(_port_sequential(root, Config(), lc), _centres(info))
    print(f"port {kind} sequential (CPU): keyframes {port[0]} valid {port[1]} ATE {port[2]!r}")
    assert jax_[0] == ref["kf_frames"] and abs(jax_[2] - ref["ate"]) <= 1e-6
    _same_slice(port, jax_, syn.DATASET_FRAMES)


def _jax_run_config_corrected_first(root, config_id, cfg):
    """The JAX eval_baseline.run_config (pipelined) with the correction
    before the remap (C17), as the reference orders them."""
    import eval_baseline as JEB
    rd = JReader(root)
    K, (w, h) = rd.camera.out_K, rd.camera.out_size
    pc = rd.photometric
    photometric = config_id == 2
    ir = jinvert(jnp.asarray(pc.gamma)) if photometric and pc.gamma is not None else None
    iv = (jnp.asarray(pc.inv_vignette)
          if photometric and pc.inv_vignette is not None else None)
    remap = jnp.asarray(rd.camera.remap)
    prep = jax.jit(lambda im: jremap(jcorrect(im, ir, iv), remap))
    slam = jsystem.SLAMSystem(K[0, 0], K[1, 1], K[0, 2], K[1, 2], w, h, cfg,
                              enable_loop_closure=config_id == 3, sequential=False)
    try:
        for i in range(len(rd)):
            fr = rd.get_raw(i)
            slam.process_frame_pipelined(np.asarray(prep(fr.image)), fr.timestamp,
                                         exposure=fr.exposure)
        slam.flush_pipeline()
        slam.finish()
    finally:
        slam.close()
    ate, n_assoc = JEB.associate_ate(slam.shells, JEB.load_groundtruth(root, None))
    return dict(kf_frames=[s.id for s in slam.shells if s.is_kf], ate=ate,
                valid=sum(s.pose_valid for s in slam.shells), gt_matched=n_assoc,
                keyframes=slam.next_kf_id)


@pytest.mark.slow
@pytest.mark.parametrize("kind,config_id", [("tum", 2), ("euroc", 3)])
def test_run_config_jax_reference_at_sensor_size(kind, config_id, tmp_path):
    """chip_smoke.py phase 15 (c) on the CPU: the JAX package's pipelined
    run_config, correction first, three times (its keyframes move with
    thread timing, C7); prints the spread that JAX_CPU_DATASET records and
    holds every rerun to the bars the port's run is held to."""
    import chip_smoke
    root, info = _dataset(tmp_path, kind)
    cfg = JConfig(max_frames=8, max_points=2048, max_immature=2048, max_features=2048,
                  pyr_levels=4)
    runs = [_jax_run_config_corrected_first(root, config_id, cfg) for _ in range(3)]
    for r in runs:
        print(f"JAX config {config_id} on {kind} (pipelined): {r}")
    ates = [r["ate"] for r in runs]
    print(f"JAX config {config_id} on {kind}: ATE {min(ates)!r} .. {max(ates)!r}")
    ref = chip_smoke.JAX_CPU_DATASET[f"config{config_id}"]
    for r in runs:
        assert r["valid"] == syn.DATASET_FRAMES and r["gt_matched"] >= 55
        assert r["keyframes"] >= 3 and r["ate"] <= max(1.5 * ref["ate_max"], 0.02)
