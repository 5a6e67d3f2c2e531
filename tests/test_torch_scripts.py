"""The port's counterparts of scripts/ (hslam_tpu_torch/tools: make_synthetic_dataset,
train_vocab, profile_kf, drive_synthetic, loop_debug, and run_sequence through
the prefetching loader), against the JAX scripts where their outputs can be
compared:

  * make_synthetic_dataset: the JAX script's main in-process and the port fed
    the JAX texture draws write byte-identical text files, vignette and
    ground truth, and images within one level;
  * train_vocab: the same diverse scenes (uint8, within one level) and, from
    the same descriptors, a bit-identical vocabulary;
  * profile_kf, drive_synthetic, loop_debug on the CPU at small sizes;
  * run_sequence through the loader and with --no-prefetch: the same
    keyframes, on a zipped and a directory dataset.

Slow tests rerun the JAX package for the records chip_smoke.py holds the card
to in phase 16: the pipelined loop sequence of loop_debug (JAX_CPU_LOOP_DEBUG)
and run_sequence over make_synthetic_dataset's default dataset
(JAX_CPU_SYNTH).
"""
import filecmp
import os
import sys

import jax
import numpy as np
import pytest
import torch

from hslam_tpu.config import Config as JConfig
from hslam_tpu.io.dataset import DatasetReader as JReader
from hslam_tpu.models import loop_closure as jlc
from hslam_tpu.models import system as jsystem
from hslam_tpu.ops import bow as jbow
from hslam_tpu.utils import lie as jlie
from hslam_tpu_torch.config import Config
from hslam_tpu_torch.io import synthetic as syn
from hslam_tpu_torch.io.trajectory import evaluate_ate, write_tum
from hslam_tpu_torch.models.system import SLAMSystem
from hslam_tpu_torch.ops import bow as tbow
from hslam_tpu_torch.tools import drive_synthetic as DS
from hslam_tpu_torch.tools import loop_debug as LD
from hslam_tpu_torch.tools import make_synthetic_dataset as MSD
from hslam_tpu_torch.tools import profile_kf as PK
from hslam_tpu_torch.tools import run_sequence as RS
from hslam_tpu_torch.tools import train_vocab as TV

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# the system configuration of the port's small end-to-end tests
# (tests/test_torch_tools.py, from tests/test_system.py:50-55)
CFG_KW = dict(max_frames=6, max_points=512, max_immature=512, max_features=512,
              pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
              desired_point_density=400.0, desired_immature_density=300.0,
              tracker_iters_per_level=(6, 10, 10))


# ------------------------------------------------------------ make_synthetic_dataset
def _jax_draws():
    """The JAX script's texture draws (scripts/make_synthetic_dataset.py:46-48)."""
    key = jax.random.PRNGKey(11)
    ky, kx = jax.random.uniform(key, (2, 8), minval=0.5, maxval=6.5)
    ph = jax.random.uniform(jax.random.fold_in(key, 1), (8,)) * 6.28
    return np.asarray(ky), np.asarray(kx), np.asarray(ph)


def test_make_synthetic_dataset_matches_the_jax_script(tmp_path, monkeypatch):
    import make_synthetic_dataset as JMSD
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    monkeypatch.setattr(sys, "argv", ["make_synthetic_dataset.py", jout, "--frames", "3",
                                      "--width", "64", "--height", "48"])
    JMSD.main()
    MSD.write_dataset(tout, 3, 64, 48, device="cpu", draws=_jax_draws())
    for name in ("camera.txt", "pcalib.txt", "times.txt", "groundtruth.txt", "vignette.png"):
        assert filecmp.cmp(os.path.join(jout, name), os.path.join(tout, name),
                           shallow=False), name
    for i in range(3):
        a, b = (cv2.imread(os.path.join(d, "images", f"{i:05d}.png"), cv2.IMREAD_GRAYSCALE)
                for d in (jout, tout))
        assert a.shape == b.shape == (48, 64)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_se3_exp_f32_has_the_jax_packages_bits():
    """The ground truth's poses: the JAX package's eager float32 se3_exp,
    bit for bit, along the dataset's path and at random twists."""
    rng = np.random.default_rng(0)
    xis = [MSD._path_xi(i / 30.0) for i in range(0, 120, 3)]
    xis += list(rng.normal(scale=0.3, size=(20, 6))) + [np.zeros(6)]
    for xi in xis:
        R, t = jlie.se3_exp(np.asarray(xi, np.float32))
        Rp, tp = MSD._se3_exp_f32(xi)
        np.testing.assert_array_equal(Rp, np.asarray(R))
        np.testing.assert_array_equal(tp, np.asarray(t))


# ------------------------------------------------------------ train_vocab
@pytest.mark.parametrize("seed", [0, 1])
def test_diverse_scene_images_match_the_jax_script(seed):
    import train_vocab as JTV
    theirs = list(JTV.diverse_scene_images(4, 3, seed=seed, H=48, W=64))
    ours = list(TV.diverse_scene_images(4, 3, seed=seed, H=48, W=64, device="cpu"))
    assert [s for s, _ in ours] == [s for s, _ in theirs] == [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3]
    for (_, a), (_, b) in zip(ours, theirs):
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape == (48, 64)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_same_descriptors_give_a_bit_identical_vocabulary(tmp_path):
    descs, docs = [], []
    for s, img in TV.diverse_scene_images(4, 2, seed=3, H=96, W=128, device="cpu"):
        d = TV.extract_descs(img, 4, 256, 10.0, device="cpu")
        descs.append(d)
        docs.append(np.full(len(d), s, np.int32))
    assert sum(len(d) for d in descs) > 50
    out = str(tmp_path / "port.npz")
    TV.train(descs, docs, k=4, levels=2, iters=6, out=out)
    jv = jbow.train_vocabulary(np.concatenate(descs), k=4, levels=2, iters=6,
                               doc_ids=np.concatenate(docs))
    jbow.save_vocabulary(str(tmp_path / "jax.npz"), jv)
    ours, theirs = np.load(out), np.load(str(tmp_path / "jax.npz"))
    assert sorted(ours.files) == sorted(theirs.files)
    for k in ours.files:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_train_vocab_cli_file_loads_into_the_system(tmp_path):
    out = str(tmp_path / "v.npz")
    voc = TV.run(TV.parse_args(["--diverse", "2", "--views", "2", "--k", "4", "--levels", "2",
                                "--out", out, "--device", "cpu"]))
    assert voc.n_words == 16 and float(voc.idf.max()) > 0
    slam = SLAMSystem(320.0, 320.0, 319.5, 239.5, 640, 480, Config(**CFG_KW), vocab_path=out,
                      device="cpu")
    try:
        img = next(TV.diverse_scene_images(1, 1, seed=9, device="cpu"))[1]
        u, v, lvl, sc, desc, valid = TV.ft.extract_multiscale(
            torch.as_tensor(img, dtype=torch.float32), 4, 256, 10.0)
        words = tbow.quantize(slam.loop_closer.vocab, desc, valid)
        assert int(valid.sum()) > 0
        assert ((words[valid] >= 0) & (words[valid] < 16)).all()
    finally:
        slam.close()


# ------------------------------------------------------------ profile_kf
def test_profile_kf_on_the_cpu(tmp_path):
    """96x128 with the port's small system configuration (tests/test_ba.py's
    CFG leaves the candidate capacities at their defaults: a 96 s warm-up)."""
    slam, frames = PK.warm_system(26, "cpu", Config(**CFG_KW), size=(96, 128, 80.0))
    try:
        assert slam.initialized and slam.next_kf_id >= 3
        out = PK.profile(slam, frames[-1], reps=2, trace=str(tmp_path / "trace"))
    finally:
        slam.close()
    names = [r[0] for r in out["rows"]]
    assert len(names) == 8 and names[0] == "pyramid build" and names[-1].startswith("kf_step")
    for name, dev_ms, host_ms in out["rows"]:
        assert dev_ms is None and np.isfinite(host_ms) and host_ms > 0, name
    assert out["state_unchanged"]
    assert os.path.getsize(out["trace_file"]) > 1000


def test_profile_kf_reports_a_phase_that_writes_the_state(monkeypatch):
    """The state check is live: a phase that updates the window in place
    (here map_cloud, replaced) makes profile report a changed state."""
    slam, frames = PK.warm_system(12, "cpu", Config(**CFG_KW), size=(96, 128, 80.0))
    monkeypatch.setattr(PK, "map_cloud", lambda frames, points, calib: points.idepth.add_(1.0))
    try:
        out = PK.profile(slam, frames[-1], reps=1)
    finally:
        slam.close()
    assert not out["state_unchanged"] and out["trace_file"] is None


# ------------------------------------------------------------ drive_synthetic
def test_drive_synthetic_on_the_cpu():
    out = DS.run("cpu")
    assert out["pyramid_shapes"] == [(240, 320, 3), (120, 160, 3), (60, 80, 3), (30, 40, 3)]
    assert out["track_ok"] and out["err1"] < 0.1 * out["err0"]
    assert np.isfinite(out["ba_rmse"])


# ------------------------------------------------------------ loop_debug
def test_loop_debug_small_sequence_counts_every_gate():
    """A short arc and loop at 96x128: the run completes through both
    threads, every detect() call ends at one counted gate."""
    out = LD.run(n_arc=20, device="cpu", cfg=Config(**CFG_KW), size=(96, 128, 80.0),
                 loop=(12, 8, 14))
    assert out["frames"] == 54 and out["valid"] == 54 and not out["lost"]
    assert out["keyframes"] >= 3 and out["lc_entries"] >= 2
    assert sum(out["gates"].values()) == out["n_detect"] > 0
    assert np.isfinite(out["ate"])


# ------------------------------------------------------------ run_sequence + loader
def _small_dataset(root, kind):
    if kind == "zip":       # TUM monoVO layout, images.zip, FOV lens, photometric calibration
        cam = ("FOV 0.535719308086809 0.669566858850269 0.493248545285398 "
               "0.500408664348414 0.897966326944875\n160 128\ncrop\n128 96\n")
        syn.write_tum(root, syn.Scene(192, 256, 64.0, n_blobs=64), 12, cam, dt=0.1,
                      path=lambda i: syn.sweep_xi(i / 10.0))
    else:                   # make_synthetic_dataset's images/ directory
        MSD.write_dataset(root, 12, 128, 96, device="cpu")


@pytest.mark.parametrize("kind", ["zip", "dir"])
def test_run_sequence_loader_and_no_prefetch_agree(kind, tmp_path):
    """Through the prefetching loader and with --no-prefetch (decode here,
    FrameCorrector): on the CPU both correct with the same functions, so
    the same frames reach the system: the same keyframes and poses."""
    root = str(tmp_path / "seq")
    _small_dataset(root, kind)
    runs = {}
    for flag in ([], ["--no-prefetch"]):
        out = str(tmp_path / f"traj{len(flag)}.txt")
        res = RS.run(RS.parse_args(["--dataset", root, "--out", out, "--device", "cpu"] + flag),
                     Config(**CFG_KW))
        slam = res.system
        assert slam.initialized and not slam.is_lost and res.n_frames == 12
        t = res.times
        assert len(t.process) == 12
        assert (len(t.wait), len(t.decode)) == ((0, 12) if flag else (12, 0))
        runs[bool(flag)] = ([s.id for s in slam.shells if s.is_kf],
                            np.stack([s.cam_to_world for s in slam.shells]))
    assert runs[True][0] == runs[False][0] and len(runs[True][0]) >= 2
    np.testing.assert_array_equal(runs[True][1], runs[False][1])


# ------------------------------------------------------------ JAX records (slow)
def _jax_gate(msg):
    for key, gate in (("qvalid", None), ("mutual ok", None), ("score", "score"),
                      ("consistency", "consistency"), ("matches", "matches"),
                      ("forward PnP", "forward PnP"), ("reverse PnP", "reverse PnP"),
                      ("mutual check", "mutual check"), ("significance", "significance")):
        if key in msg:
            return gate
    return "other"


@pytest.mark.slow
def test_loop_debug_jax_reference(monkeypatch):
    """chip_smoke.py phase 16's loop_debug (n_arc 60: phase 11's 326 frames)
    through the JAX package's pipelined entry on XLA:CPU, as
    scripts/bench_loop_debug.py runs it, three times (the keyframes move
    with thread timing, C7). Prints what chip_smoke.JAX_CPU_LOOP_DEBUG
    records; every rerun keeps all poses valid."""
    import collections

    import chip_smoke
    Hh, Ww, fx = 480, 640, 320.0
    scene = syn.Scene(Hh, Ww, fx)
    frames, centres = syn.make_sequence(scene, 60)
    lf, lc, ls = syn.make_loop_frames(scene, 60)
    allc = np.concatenate([centres, lc])
    runs = []
    for _ in range(3):
        gates = collections.Counter()
        monkeypatch.setattr(jlc, "_LC_DEBUG", True)
        monkeypatch.setattr(jlc, "_dbg", lambda m: gates.update([_jax_gate(m)]))
        js = jsystem.SLAMSystem(fx, fx, Ww / 2 - 0.5, Hh / 2 - 0.5, Ww, Hh,
                                JConfig(max_frames=8, max_points=2048, max_immature=2048,
                                        pyr_levels=6), sequential=False)
        try:
            for i, f in enumerate(frames):
                js.process_frame_pipelined(f, 0.05 * i)
            js.flush_pipeline()
            js.finish()
            js.wait_compiles()
            for f, ts in zip(lf, ls):
                js.process_frame_pipelined(f, ts)
            js.flush_pipeline()
            js.finish()
        finally:
            js.close()
        valid = [s.id for s in js.shells if s.pose_valid]
        from hslam_tpu_torch.io.trajectory import ate_rmse
        ate = ate_rmse(allc[valid], np.array([js.shells[i].cam_to_world[:3, 3] for i in valid]))
        gates.pop(None, None)
        r = dict(keyframes=js.next_kf_id, valid=len(valid), ate=float(ate),
                 loops_closed=js.n_loops_closed,
                 verified_insignificant=js.loop_closer.n_verified_insignificant,
                 relocs=js.n_relocs, gates=dict(gates))
        print("JAX loop_debug (pipelined):", r)
        runs.append(r)
    ref = chip_smoke.JAX_CPU_LOOP_DEBUG
    print("JAX loop_debug ATE", min(r["ate"] for r in runs), "..", max(r["ate"] for r in runs))
    for r in runs:
        assert r["valid"] == 326
        assert r["ate"] <= max(1.5 * ref["ate_max"], 0.02)


@pytest.mark.slow
def test_synthetic_dataset_run_sequence_jax_reference(tmp_path):
    """chip_smoke.py phase 16's make_synthetic_dataset (its defaults, 320x240,
    60 frames; rendered on the CPU) then run_sequence --loop-closure through
    the loader, in both packages (the JAX script's dataset branch keeps loop
    closure on, C18): the record chip_smoke.JAX_CPU_SYNTH holds, and the
    port on the CPU keyframes the same frames."""
    import hashlib

    import chip_smoke
    from hslam_tpu.ops.undistort import invert_response as jinvert
    from hslam_tpu.ops.undistort import photometric_correct as jcorrect
    from hslam_tpu.ops.undistort import remap_image as jremap
    import jax.numpy as jnp
    root = str(tmp_path / "seq")
    MSD.write_dataset(root, device="cpu")
    digest = hashlib.sha256()
    for i in range(60):
        digest.update(cv2.imread(os.path.join(root, "images", f"{i:05d}.png"),
                                 cv2.IMREAD_GRAYSCALE).tobytes())
    rd = JReader(root)
    K, (w, h) = rd.camera.out_K, rd.camera.out_size
    ir = jinvert(jnp.asarray(rd.photometric.gamma))
    iv = jnp.asarray(rd.photometric.inv_vignette)
    remap = jnp.asarray(rd.camera.remap)
    prep = jax.jit(lambda im: jremap(jcorrect(im, ir, iv), remap))
    js = jsystem.SLAMSystem(K[0, 0], K[1, 1], K[0, 2], K[1, 2], w, h, JConfig())
    try:
        for i in range(len(rd)):
            fr = rd.get_raw(i)
            js.process_frame(np.asarray(prep(fr.image)), fr.timestamp, fr.exposure)
    finally:
        js.close()
    jtraj = str(tmp_path / "jax.txt")
    write_tum(jtraj, [s.timestamp for s in js.shells],
              [(s.cam_to_world[:3, :3], s.cam_to_world[:3, 3]) for s in js.shells])
    gt = os.path.join(root, "groundtruth.txt")
    jax_ = dict(sha256=digest.hexdigest(), kf_frames=[s.id for s in js.shells if s.is_kf],
                valid=sum(s.pose_valid for s in js.shells), ate=evaluate_ate(gt, jtraj))
    print("JAX synthetic dataset:", jax_)
    out = str(tmp_path / "port.txt")
    res = RS.run(RS.parse_args(["--dataset", root, "--out", out, "--loop-closure",
                                "--device", "cpu"]))
    port = dict(kf_frames=[s.id for s in res.system.shells if s.is_kf],
                valid=sum(s.pose_valid for s in res.system.shells), ate=evaluate_ate(gt, out))
    print("port synthetic dataset (CPU):", port)
    ref = chip_smoke.JAX_CPU_SYNTH
    assert jax_["sha256"] == ref["sha256"] and jax_["kf_frames"] == ref["kf_frames"]
    assert jax_["valid"] == 60 and abs(jax_["ate"] - ref["ate"]) <= 1e-6
    assert port["valid"] == 60 and abs(len(port["kf_frames"]) - len(jax_["kf_frames"])) <= 1
    assert port["ate"] <= max(1.5 * jax_["ate"], 0.02)
