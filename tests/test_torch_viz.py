"""The port's viz/ against the JAX package's on the same state: the window
point cloud, the PLY writers, the debug overlays, and the live-map server
and terminal dashboard over the port's own metrics stream from a short
sequential run (96x128, the small config of tests/test_system.py)."""
import io
import json
import os
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hslam_tpu.viz import debug_draw as jdd
from hslam_tpu.viz import export as jex
from hslam_tpu.viz import view3d as jv3
from hslam_tpu_torch.config import Config
from hslam_tpu_torch.convert import to_numpy
from hslam_tpu_torch.io.synthetic import Scene, make_sequence, sweep_xi
from hslam_tpu_torch.models.system import SLAMSystem
from hslam_tpu_torch.viz import debug_draw as tdd
from hslam_tpu_torch.viz import export as tex
from hslam_tpu_torch.viz import view3d as tv3

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

H, W, FX = 96, 128, 80.0
CX, CY = W / 2 - 0.5, H / 2 - 0.5
CFG_KW = dict(max_frames=6, max_points=512, max_immature=512, max_features=512,
              pyr_levels=3, init_min_matches=50, init_ransac_iters=100,
              desired_point_density=400.0, desired_immature_density=300.0,
              tracker_iters_per_level=(6, 10, 10))
N_FRAMES = 12
# the record keys the JAX package writes (hslam_tpu/models/system.py: the
# "frame" record of process_frame, the "kf" and "map" records of a keyframe)
FRAME_KEYS = {"t", "id", "ts", "kf", "rmse", "pose_valid", "reloc", "p"}
KF_KEYS = {"t", "id", "kf_id", "ba_rmse", "n_active", "n_ind", "n_marg_frames", "latency_ms"}
MAP_KEYS = {"t", "kf_id", "pts", "kfs"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's sequential hybrid system over the sweep with a metrics
    stream: (system, stream path, last frame)."""
    frames, _ = make_sequence(Scene(H, W, FX, n_blobs=16), N_FRAMES,
                              lambda i: sweep_xi(i / 10.0))
    path = str(tmp_path_factory.mktemp("viz") / "metrics.jsonl")
    slam = SLAMSystem(FX, FX, CX, CY, W, H, Config(**CFG_KW), enable_loop_closure=False,
                      metrics_path=path, device="cpu")
    for i, f in enumerate(frames):
        slam.process_frame(f, i / 10.0)
    slam.close()
    assert slam.initialized and not slam.is_lost and slam.next_kf_id >= 3
    return slam, path, frames[-1].astype(np.float32)


@pytest.mark.parametrize("filt", [(0.0, 1e8), (0.01, 1e-2)], ids=["all", "filtered"])
def test_window_pointcloud_matches_jax(run, filt):
    slam = run[0]
    a = tex.window_pointcloud(slam.window, slam.calib, *filt)
    jw = jax.tree_util.tree_map(jnp.asarray, to_numpy(slam.window))
    jc = jax.tree_util.tree_map(jnp.asarray, to_numpy(slam.calib))
    b = jex.window_pointcloud(jw, jc, None, *filt)
    assert len(a[0]) == len(b[0]) > 10
    np.testing.assert_allclose(a[0], b[0], atol=1e-5)
    np.testing.assert_array_equal(a[1], b[1])
    # the cloud lies in front of the first camera (bootstrap depths ~1)
    assert 0.5 < float(np.median(a[0][:, 2])) < 8.0


@pytest.mark.parametrize("with_intensity", [True, False], ids=["intensity", "plain"])
def test_write_ply_byte_identical(run, with_intensity, tmp_path):
    xyz, col = tex.window_pointcloud(run[0].window, run[0].calib)
    col = col if with_intensity else None
    a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    tex.write_ply(a, xyz, col)
    jex.write_ply(b, xyz, col)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert open(a).read().count("\n") == len(xyz) + (10 if with_intensity else 7)


def test_write_trajectory_ply_byte_identical(run, tmp_path):
    pos = np.array([s.cam_to_world[:3, 3] for s in run[0].shells])
    a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    tex.write_trajectory_ply(a, pos)
    jex.write_trajectory_ply(b, pos)
    assert open(a, "rb").read() == open(b, "rb").read()


def _template(slam):
    return [x[0].numpy() for x in (slam.template.u, slam.template.v,
                                   slam.template.idepth, slam.template.valid)]


@pytest.mark.parametrize("marks", [True, False], ids=["marked", "bare"])
def test_draw_frame_pixel_identical(run, marks):
    _, _, img = run
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, [W, H], (40, 2)) if marks else None
    cands = rng.uniform(0, [W, H], (60, 2)) if marks else None
    a = tdd.draw_frame(img, pts, cands)
    np.testing.assert_array_equal(a, jdd.draw_frame(img, pts, cands))
    assert a.shape == (H, W, 3) and a.dtype == np.uint8


def test_draw_template_depth_and_colormap_pixel_identical(run):
    slam, _, img = run
    u, v, idp, ok = _template(slam)
    assert ok.sum() > 10
    np.testing.assert_array_equal(tdd.draw_template_depth(img, u, v, idp, ok),
                                  jdd.draw_template_depth(img, u, v, idp, ok))
    dense = np.random.default_rng(1).uniform(0.2, 1.0, (H, W)).astype(np.float32)
    valid = dense > 0.4
    np.testing.assert_array_equal(tdd._colormap_idepth(dense, valid),
                                  jdd._colormap_idepth(dense, valid))


def test_save_debug_frame_draws_the_template(run, tmp_path):
    slam, _, img = run
    p = str(tmp_path / "kf.png")
    tdd.save_debug_frame(p, slam, img)
    np.testing.assert_array_equal(cv2.imread(p), jdd.draw_template_depth(img, *_template(slam)))


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


def test_map_server_serves_the_ports_stream(run, tmp_path):
    """/ serves the page; /data?from=N returns the stream's complete records
    from byte N, with the JAX schema, as the JAX package's server does."""
    _, path, _ = run
    recs = [json.loads(ln) for ln in open(path)]
    kinds = {t: [r for r in recs if r["t"] == t] for t in ("frame", "kf", "map")}
    assert all(kinds.values())
    assert all(set(r) == FRAME_KEYS for r in kinds["frame"])
    assert all(set(r) == KF_KEYS for r in kinds["kf"])
    assert all(set(r) == MAP_KEYS for r in kinds["map"])
    live = str(tmp_path / "live.jsonl")
    with open(live, "w") as f:
        f.write(open(path).read())
        f.write('{"t": "frame", "id":')          # a writer's partial tail line
    srv = tv3.MapServer(live, port=0).start()
    ref = jv3.MapServer(live, port=0).start()
    try:
        assert srv.port not in (0, ref.port)
        page = _get(srv.url + "/").decode()
        assert "webgl" in page and "frustumLines" in page
        body = _get(srv.url + "/data?from=0")
        assert body == _get(ref.url + "/data?from=0")
        d = json.loads(body)
        assert d["records"] == recs and d["next"] == os.path.getsize(path)
        mid = len(open(path).readline().encode())
        d2 = json.loads(_get(srv.url + f"/data?from={mid}"))
        assert d2["records"] == recs[1:]
        d3 = json.loads(_get(srv.url + f"/data?from={d['next']}"))
        assert d3 == {"next": d["next"], "records": []}
    finally:
        srv.stop()
        ref.stop()


def test_live_view_follows_the_ports_stream(run):
    from live_view import follow
    _, path, _ = run
    recs = [json.loads(ln) for ln in open(path)]
    out = io.StringIO()
    dash = follow(path, once=True, out=out)
    assert dash.n_frames == sum(r["t"] == "frame" for r in recs) > 0
    assert dash.n_kf == sum(r["t"] == "kf" for r in recs) > 0
    assert f"frames {dash.n_frames:5d}" in out.getvalue()
