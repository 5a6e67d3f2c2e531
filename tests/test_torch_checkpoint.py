"""Checkpoint / resume in the port (hslam_tpu_torch/io/checkpoint.py): a
mid-sequence snapshot restores bit for bit and the restored system goes on
exactly as the one that never stopped (the determinism test of
tests/test_checkpoint.py, at its small CFG, on the CPU); the archive has the
JAX package's key names and dtypes, so a checkpoint written by either
package restores into the other."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslam_tpu.config import Config as JConfig
from hslam_tpu.io import checkpoint as jckpt
from hslam_tpu.models.system import Shell as JShell
from hslam_tpu.models.system import SLAMSystem as JSLAM
from hslam_tpu_torch.config import Config
from hslam_tpu_torch.convert import to_numpy
from hslam_tpu_torch.io import checkpoint as tckpt
from hslam_tpu_torch.io.synthetic import Scene, make_sequence, sweep_xi
from hslam_tpu_torch.models.system import SLAMSystem

torch.set_num_threads(1)

H, W, FX = 96, 128, 80.0
CX, CY = W / 2 - 0.5, H / 2 - 0.5
# tests/test_checkpoint.py:18-23
CFG_KW = dict(max_frames=6, max_points=256, max_immature=256, max_features=256,
              pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
              desired_point_density=200.0, desired_immature_density=150.0,
              tracker_iters_per_level=(6, 10, 10))
N, SNAP = 16, 10


def _frames():
    return make_sequence(Scene(H, W, FX, n_blobs=16), N, lambda i: sweep_xi(i / 10.0))[0]


def _port():
    return SLAMSystem(FX, FX, CX, CY, W, H, Config(**CFG_KW), enable_loop_closure=False,
                      device="cpu")


def _leaves(system):
    """Every tensor and host mirror a checkpoint carries, by key."""
    out = {}
    for prefix, tree in (("window", system.window), ("immt", system.imm),
                         ("feats", system.feats), ("template", system.template)):
        out.update(tckpt._named_leaves(tree, prefix))
    out["calib/value"] = system.calib.value
    out["calib/value_zero"] = system.calib.value_zero
    for name in tckpt._MIRRORS:
        out["mirror/" + name] = torch.from_numpy(np.asarray(getattr(system, name)))
    return out


def _assert_same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), k
    for s, r in zip(a.shells, b.shells):
        assert (s.id, s.is_kf, s.kf_id, s.tracking_ref, s.pose_valid) == (
            r.id, r.is_kf, r.kf_id, r.tracking_ref, r.pose_valid)
        np.testing.assert_array_equal(s.cam_to_world, r.cam_to_world)
    for name in ("slot_shell", "initialized", "frame_count", "next_kf_id", "kf_shell_ids",
                 "current_min_act_dist", "first_coarse_rmse", "ref_slot", "ref_shell_id",
                 "ref_exposure", "_marg_counts", "_m_n_active"):
        assert getattr(a, name) == getattr(b, name), name
    np.testing.assert_array_equal(a.last_coarse_rmse, b.last_coarse_rmse)
    np.testing.assert_array_equal(a.ref_aff, b.ref_aff)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """The port at frame SNAP of the sweep and its checkpoint."""
    frames = _frames()
    slam = _port()
    for i in range(SNAP):
        slam.process_frame(frames[i], i / 10.0)
    assert slam.initialized and slam.next_kf_id >= 3
    path = str(tmp_path_factory.mktemp("ckpt") / "port.npz")
    tckpt.save_state(path, slam)
    return frames, slam, path


def test_restore_is_bit_for_bit(snapshot):
    _, slam, path = snapshot
    fresh = _port()
    assert fresh.template is None
    tckpt.load_state(path, fresh)
    _assert_same_state(slam, fresh)
    # the per-level intrinsics follow the restored calibration
    torch.testing.assert_close(fresh._K_pyr_cache, slam._K_pyr_cache, rtol=0, atol=0)


def test_roundtrip_and_determinism(snapshot):
    """tests/test_checkpoint.py::test_checkpoint_roundtrip_and_determinism on
    the port: a straight run and a run restored at frame 10 give the same
    poses within 1e-5."""
    frames, _, path = snapshot
    a = _port()
    for i, img in enumerate(frames):
        a.process_frame(img, i / 10.0)
    b = _port()
    tckpt.load_state(path, b)
    for i in range(SNAP, N):
        b.process_frame(frames[i], i / 10.0)
    assert a.initialized and b.initialized and a.next_kf_id == b.next_kf_id
    assert len(a.shells) == len(b.shells) == N
    for sa, sb in zip(a.shells, b.shells):
        np.testing.assert_allclose(sa.cam_to_world, sb.cam_to_world, atol=1e-5,
                                   err_msg=f"frame {sa.id}")


def _jax_shells(shells):
    return [JShell(id=s.id, timestamp=s.timestamp, exposure=s.exposure,
                   cam_to_world=s.cam_to_world.copy(), tracking_ref=s.tracking_ref,
                   cam_to_ref=s.cam_to_ref.copy(), aff=np.array(s.aff), is_kf=s.is_kf,
                   kf_id=s.kf_id, pose_valid=s.pose_valid) for s in shells]


def test_archive_matches_the_jax_package(snapshot, tmp_path):
    """The JAX package's save_state of the same state writes the same keys,
    dtypes and values as the port's; its file restores into the port bit for
    bit."""
    _, slam, path = snapshot
    js = JSLAM(FX, FX, CX, CY, W, H, JConfig(**CFG_KW), enable_loop_closure=False)
    as_jax = jax.tree_util.tree_map(jnp.asarray, to_numpy((slam.window, slam.imm, slam.feats,
                                                           slam.template)))
    js.window, js.imm, js.feats, js.template = as_jax
    js.calib = js.calib._replace(value=jnp.asarray(slam.calib.value.numpy()),
                                 value_zero=jnp.asarray(slam.calib.value_zero.numpy()))
    for name in tckpt._MIRRORS + ("slot_shell", "initialized", "frame_count", "next_kf_id",
                                  "kf_shell_ids", "current_min_act_dist", "last_coarse_rmse",
                                  "first_coarse_rmse", "ref_slot", "ref_shell_id", "ref_aff",
                                  "ref_exposure", "_marg_counts"):
        setattr(js, name, getattr(slam, name))
    js.shells = _jax_shells(slam.shells)
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_state(jpath, js)
    js.close()
    dj, dt = np.load(jpath), np.load(path)
    assert sorted(dj.files) == sorted(dt.files)
    assert "window/.frames/.valid" in dt.files and "template/.u/[0]" in dt.files
    for k in dj.files:
        if k == "__meta__":
            continue
        assert dj[k].dtype == dt[k].dtype, k
        np.testing.assert_array_equal(dj[k], dt[k], err_msg=k)
    fresh = _port()
    tckpt.load_state(jpath, fresh)
    _assert_same_state(slam, fresh)


@pytest.mark.slow
def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package runs 10 frames and saves; the port restores and runs
    the last 6. Held to the JAX package's straight run: same keyframes
    within one, poses within 5 mm (scene depth 2.0; the two packages draw
    other random numbers and differ by fault C1, ROADMAP)."""
    frames = _frames()
    ja = JSLAM(FX, FX, CX, CY, W, H, JConfig(**CFG_KW), enable_loop_closure=False)
    for i, img in enumerate(frames):
        ja.process_frame(img, i / 10.0)
    jb = JSLAM(FX, FX, CX, CY, W, H, JConfig(**CFG_KW), enable_loop_closure=False)
    for i in range(SNAP):
        jb.process_frame(frames[i], i / 10.0)
    path = os.path.join(str(tmp_path), "jax.npz")
    jckpt.save_state(path, jb)
    tb = _port()
    tckpt.load_state(path, tb)
    for i in range(SNAP, N):
        tb.process_frame(frames[i], i / 10.0)
        assert not tb.is_lost
    assert tb.initialized and abs(tb.next_kf_id - ja.next_kf_id) <= 1
    for sa, sb in zip(ja.shells, tb.shells):
        assert sb.pose_valid
        assert np.linalg.norm(sa.cam_to_world[:3, 3] - sb.cam_to_world[:3, 3]) < 5e-3, sa.id
