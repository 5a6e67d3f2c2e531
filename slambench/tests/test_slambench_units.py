"""The benchmark's own arithmetic and its guards, on the CPU."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from slambench import registry, roofline, scene, stats
from slambench.reference import lens as RL
from slambench.run import forbidden_modules

REF_DIR = os.path.join(registry.HERE, "reference")


def test_cells_configs_mixes_and_metrics_are_found_by_name():
    bench = registry.load_benchmark()
    for cell in bench["workloads"]:
        cfg = registry.config(cell["config"])
        assert cfg["name"] == cell["config"]
        assert registry.traffic(cell["traffic"])["path"] in ("laps", "line")
        for m in registry.per_layer(bench, cell["name"]):
            mod = registry.metric_module(m["name"])
            assert mod.UNIT == m["unit"]
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(registry.REPO, c["file"]))
    for name in os.listdir(os.path.join(registry.HERE, "metrics")):
        if name.endswith(".py"):
            assert registry.metric_module(name[:-3]).UNIT


@pytest.mark.parametrize("cfg_name", ["euroc_mh", "tum_mono_calib"])
def test_renderer_is_deterministic_from_the_seed(cfg_name):
    cfg = registry.config(cfg_name)
    cfg = dict(cfg, camera_txt=_small_camera(cfg["camera_txt"]))
    traffic = dict(registry.traffic("laps"), laps_rendered=4, lap_s=0.1)
    a = scene.render_stream(cfg, traffic, 2 ** 31 + 77, 0, "cpu")
    b = scene.render_stream(cfg, traffic, 2 ** 31 + 77, 0, "cpu")
    assert torch.equal(a.frames, b.frames) and np.array_equal(a.exposures, b.exposures)
    assert a.order == b.order
    assert a.frames.dtype == torch.uint8 and a.frames.float().std() > 10
    # every seed: the same laps, the first fed first, the others in a seeded order
    orders = {tuple(scene.render_stream(cfg, traffic, s, 0, "cpu").order) for s in range(8)}
    assert len(orders) > 1 and all(o[0] == 0 and sorted(o) == [0, 1, 2, 3] for o in orders)
    c = scene.render_stream(cfg, traffic, 5, 0, "cpu")
    assert torch.equal(a.frames, c.frames)
    lap = a.period
    assert not torch.equal(a.frames[:lap], a.frames[lap:2 * lap])    # laps differ in noise
    assert [a.slot(j) for j in (0, lap, 4 * lap + 1)] == [0, a.order[1] * lap, 1]


def _small_camera(text):
    from slambench.tests.tiny import quarter_camera
    return quarter_camera(text)


@pytest.mark.parametrize("cfg_name", ["euroc_mh", "tum_mono_calib"])
def test_lens_rays_match_the_frozen_equations(cfg_name):
    """The renderer's ray of every raw pixel distorts back onto the pixel,
    and the frozen equations agree with the program's copy of them."""
    from hslam_tpu_torch.io import calib_io
    cam = RL.parse_camera_txt(registry.config(cfg_name)["camera_txt"])
    p = cam.params
    w, h = cam.in_size
    ys, xs = np.mgrid[0:h:7, 0:w:7].astype(np.float64)
    xd, yd = (xs - p[2]) / p[0], (ys - p[3]) / p[1]
    x, y = RL.undistort(cam.model, p[4:], xd, yd)
    bx, by = RL.distort(cam.model, p[4:], x, y)
    assert np.max(np.hypot(bx - xd, by - yd)) < 1e-9
    px, py = calib_io._distort(cam.model, p[4:], x, y)
    assert np.max(np.abs(px - bx)) < 1e-12 and np.max(np.abs(py - by)) < 1e-12


def test_paths_laps_repeat_and_lines_never_do():
    laps = registry.traffic("laps")
    R, t, C, period = scene.path_poses(laps, 20.0, 201)
    assert period == 100
    assert np.allclose(R[0], R[100]) and np.allclose(C[0], C[200])
    step = np.linalg.norm(np.diff(C, axis=0), axis=1)
    assert 0.012 < step.mean() < 0.024      # about MH_01's pace, 0.018 m a frame
    line = dict(laps, path="line", speed_m_s=0.366, wobble_period_s=5.0)
    _, _, Cl, period = scene.path_poses(line, 20.0, 300)
    assert period == 0 and np.all(np.diff(Cl[:, 0]) > 0)


def test_p95_and_fps_on_a_window_with_a_stall():
    # 100 frames: 99 of 200 ms, one stalled for 3 s; the window is 22.8 s
    handed = [0.2 * i for i in range(100)]
    lat = [0.2] * 100
    lat[50] = 3.0
    returned = [h + x for h, x in zip(handed, lat)]
    m = stats.window_metrics(handed, returned, 0.0, 22.8)
    assert m["n"] == 100
    assert m["fps"] == pytest.approx(100 / 22.8)
    assert m["frame_ms_p95"] == pytest.approx(200.0)
    lat[51:56] = [3.0] * 5           # six stalls: the p95 sees them
    returned = [h + x for h, x in zip(handed, lat)]
    assert stats.window_metrics(handed, returned, 0.0, 22.8)["frame_ms_p95"] == pytest.approx(
        3000.0)


@pytest.mark.parametrize("itemsize,want", [(1, 6_859_200), (4, 7_780_800)])
def test_pyramid_bytes(itemsize, want):
    assert roofline.pyramid_bytes(480, 640, 6, itemsize) == want


@pytest.mark.parametrize("mods,bad", [
    (["hslam_tpu_torch", "hslam_tpu_torch.ops.tracker", "torch", "jax_like"], []),
    (["hslam_tpu", "hslam_tpu.ops"], ["hslam_tpu", "hslam_tpu.ops"]),
    (["jax", "jaxlib.xla_client", "flax.linen", "jaxtyping"], ["flax.linen", "jax",
                                                             "jaxlib.xla_client"]),
])
def test_import_check_compares_whole_top_level_names(mods, bad):
    assert forbidden_modules({m: None for m in mods}) == bad


def test_reference_imports_nothing_of_the_port_or_jax():
    for name in os.listdir(REF_DIR):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(REF_DIR, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]] if not node.level else []
            else:
                continue
            assert not set(tops) & {"jax", "jaxlib", "flax", "hslam_tpu", "hslam_tpu_torch"}, (
                name, tops)
    code = ("import sys; import slambench.reference.image, slambench.reference.tracker, "
            "slambench.reference.lens, slambench.reference.photo_calib; print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=registry.REPO, check=True).stdout
    tops = set(json.loads(out.replace("'", '"')))
    assert not tops & {"jax", "jaxlib", "flax", "hslam_tpu", "hslam_tpu_torch"}


@pytest.mark.parametrize("with_prev", [False, True])
def test_reference_refit_follows_the_stated_fit(with_prev):
    """On the same observations in float64 the reference's refit and the
    program's give the same correction; the bfloat16 control does not."""
    from hslam_tpu_torch.models import photo_calib as PC
    from hslam_tpu_torch.ops.undistort import invert_response
    from slambench.reference import photo_calib as RP
    settings = registry.config("tum_mono_calib")["photo_calib"]
    g = torch.Generator().manual_seed(3)
    P, F, H, W = 300, 8, 48, 64
    radiance = 20 + 200 * torch.rand(P, 1, generator=g, dtype=torch.float64)
    r2 = torch.rand(P, F, generator=g, dtype=torch.float64)
    exp = 1 + 0.35 * torch.sin(0.45 * torch.arange(F, dtype=torch.float64))
    irr = torch.clamp(exp * (1 - 0.45 * r2) * radiance / 255, 0, 1)
    obs = 255 * irr ** 0.7 + torch.randn(P, F, generator=g, dtype=torch.float64)
    mask = torch.rand(P, F, generator=g) > 0.1
    prev = PC.init_params(F, device="cpu")
    prev = PC.PhotoParams(*(x.double() for x in prev))._replace(
        vig=torch.tensor([-0.3, 0.0, 0.0], dtype=torch.float64)) if with_prev else None
    start = PC.PhotoParams(*(x.double() for x in PC.init_params(F, device="cpu")))
    if prev is not None:
        start = prev._replace(log_exp=prev.log_exp.new_zeros(F))
    p, _ = PC.calibrate(start, obs, torch.arange(F), r2, mask, exp_known=exp, prev=prev)
    want_b = invert_response(PC.gamma_lut(p))
    want_v = 1.0 / PC.vignette_map(p, H, W)
    in_force = (torch.arange(256, dtype=torch.float64), torch.ones(H, W, dtype=torch.float64))
    b, v = RP.refit(prev, in_force if prev is not None else None, obs, r2, mask, exp,
                    settings, H, W)
    if prev is not None:
        a = settings["blend"]
        want_b, want_v = (1 - a) * in_force[0] + a * want_b, (1 - a) * in_force[1] + a * want_v
    # the program builds its radius map in float32
    assert torch.max(torch.abs(b - want_b)) < 1e-6 and torch.max(torch.abs(v - want_v)) < 1e-6
    cb, cv = RP.refit(prev, in_force if prev is not None else None, obs.bfloat16(),
                      r2.bfloat16(), mask, exp.bfloat16(), settings, H, W)
    gap = torch.max(torch.abs(cb.double()[:, None] * cv.double().reshape(-1)[None]
                              - b[:, None] * v.reshape(-1)[None]))
    assert gap > 1.0


@pytest.mark.parametrize("entry", ["sequential", "pipelined", "unknown"])
def test_a_run_keeps_to_a_core_for_each_of_its_entry_threads(entry):
    """In a process of its own, so that this one keeps its cores."""
    code = ("import os, sys; sys.path.insert(0, '.'); from slambench.run import pin_cores; "
            f"before = sorted(os.sched_getaffinity(0)); after = pin_cores({entry!r}); "
            "print(before, after, sorted(os.sched_getaffinity(0)))")
    p = subprocess.run([sys.executable, "-c", code], cwd=registry.REPO, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    before, after, now = (json.loads(x) for x in p.stdout.strip().replace("] [", "]|[").split("|"))
    want = {"sequential": 1, "pipelined": 3}.get(entry, len(before))
    assert after == now == before[-min(want, len(before)):]


def test_a_run_without_a_card_fails_and_prints_no_result(tmp_path):
    """Here, with no card, and in a directory that holds only BENCHMARK.json
    and the benchmark's files."""
    import shutil
    shutil.copy(os.path.join(registry.REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(registry.HERE, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (registry.REPO, tmp_path):
        p = subprocess.run([sys.executable, "slambench/run.py", "--workload", "tum_mono_calib.laps",
                            "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
                           capture_output=True, text=True, timeout=300,
                           env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert p.returncode != 0
        assert p.stdout.strip() == ""


@pytest.mark.gpu
def test_a_short_run_on_the_card_prints_the_result():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "slambench/run.py", "--workload", "tum_mono_calib.laps",
                        "--seed", str(2 ** 31 + 999), "--seconds", "5", "--trace", "0"],
                       cwd=registry.REPO, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert set(res["metrics"]) == {"fps", "frame_ms_p95", "setup_s"}
