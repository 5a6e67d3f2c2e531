"""hslam_tpu_torch: Config and constants equal the JAX package's; the port
imports no jax; options are refused, not silently skipped, where the port
does not run them."""
import copy
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import hslam_tpu.config as jcfg
import hslam_tpu_torch.config as tcfg

torch.set_num_threads(1)


def test_config_fields_and_defaults_equal():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.Config)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.Config)]
    assert tf == jf
    assert tcfg.DEFAULT_CONFIG == tcfg.Config()


@pytest.mark.parametrize("name", [
    "PATTERN", "PATTERN_NUM", "PATTERN_PADDING", "CPARS", "SCALE_IDEPTH",
    "SCALE_XI_TRANS", "SCALE_XI_ROT", "SCALE_F", "SCALE_C", "SCALE_A",
    "SCALE_B", "FRAME_STATE_SCALE", "CALIB_SCALE"])
def test_constants_equal(name):
    a, b = getattr(tcfg, name), getattr(jcfg, name)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


def test_numerics_policy_tf32_off():
    import hslam_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_port_imports_no_jax():
    """Every module of the port imports without pulling jax or hslam_tpu in."""
    code = (
        "import pkgutil, importlib, sys, hslam_tpu_torch\n"
        "for m in pkgutil.walk_packages(hslam_tpu_torch.__path__, 'hslam_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'hslam_tpu.'))"
        " or k == 'hslam_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_port_sources_name_no_jax_import():
    """No source of the port, and not the chip smoke script, has an import
    statement for jax or for the JAX package (its data file is read by
    path)."""
    root = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((root / "hslam_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 25
    pat = re.compile(r"^\s*(import|from)\s+(jax|hslam_tpu)(\.|\s|$)", re.M)
    bad = [str(f.relative_to(root)) for f in files if pat.search(f.read_text())]
    assert not bad, bad


SLICE = dict(enable_indirect=False, init_direct_refine=False)


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A port Mesh over a world of one (Gloo, file rendezvous), torn down
    with the module: the default group is global state in a worker."""
    from hslam_tpu_torch.parallel import distributed as D
    D.initialize(f"file://{tmp_path_factory.mktemp('rdv')}/rdv", 1, 0, "gloo")
    yield D.global_mesh("points")
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("kwargs", [
    dict(cfg=dict(SLICE, max_points=256), dist_mesh=3),
], ids=["dist_mesh"])
def test_system_refuses_unported_options(kwargs, mesh1):
    """dist_mesh is ported: the system takes a port Mesh (and hands its
    kf_step the mesh and its loop closer a group of its own), and, as the
    JAX package, refuses a mesh whose size does not divide max_points."""
    import jax
    from jax.sharding import Mesh as JMesh

    from hslam_tpu.models.system import SLAMSystem as JSLAM
    from hslam_tpu_torch.models.system import SLAMSystem
    kw = dict(enable_loop_closure=False)
    kw.update(kwargs)
    cfg = tcfg.Config(**kw.pop("cfg"))
    n = kw.pop("dist_mesh")
    args = (80.0, 80.0, 63.5, 47.5, 128, 96)
    with pytest.raises(AssertionError):
        JSLAM(*args, jcfg.Config(**dataclasses.asdict(cfg)),
              dist_mesh=JMesh(np.array(jax.devices()[:n]), ("points",)), **kw)
    wide = copy.copy(mesh1)
    wide.size = n                # what a mesh of n ranks reports
    with pytest.raises(ValueError, match="max_points"):
        SLAMSystem(*args, cfg, device="cpu", dist_mesh=wide, **kw)
    slam = SLAMSystem(*args, cfg, device="cpu", dist_mesh=mesh1, **kw)
    assert slam.dist_mesh is mesh1 and slam._edge_mesh.size == 1
    assert slam._edge_mesh.group is not mesh1.group


@pytest.mark.parametrize("kwargs", [
    dict(cfg=dict(enable_indirect=True, init_direct_refine=False)),
    dict(cfg=dict(enable_indirect=False, init_direct_refine=True)),
    dict(cfg=dict(SLICE, use_fast=True)),
    dict(cfg=SLICE, sequential=False),
    dict(cfg=SLICE, enable_loop_closure=True),
    dict(cfg={}, enable_loop_closure=True, sequential=False),
    dict(cfg={}, enable_loop_closure=True, vocab_path="online"),
    dict(cfg=SLICE, online_photo_calib=True),
    dict(cfg={}, online_photo_calib=True, photo_calib_every=4, sequential=False),
    dict(cfg=SLICE, metrics_path="metrics.jsonl"),
    dict(cfg={}, metrics_path="metrics.jsonl", sequential=False, enable_loop_closure=True),
], ids=["indirect", "init_refine", "use_fast", "pipelined", "loop_closure",
        "loop_closure_pipelined", "loop_closure_online_vocabulary", "photo_calib",
        "photo_calib_pipelined", "metrics_stream", "metrics_stream_pipelined"])
def test_system_accepts_ported_options(kwargs, tmp_path):
    """The ported options construct a system, which closes cleanly."""
    from hslam_tpu_torch.models.system import SLAMSystem
    kw = dict(enable_loop_closure=False)
    kw.update(kwargs)
    cfg = tcfg.Config(**kw.pop("cfg"))
    if "metrics_path" in kw:
        kw["metrics_path"] = str(tmp_path / kw["metrics_path"])
    slam = SLAMSystem(80.0, 80.0, 63.5, 47.5, 128, 96, cfg, device="cpu", **kw)
    assert slam.online_photo_calib == kw.get("online_photo_calib", False)
    assert slam._pc_ring.maxlen == kw.get("photo_calib_every", 8) and slam._pc_luts is None
    if kw["enable_loop_closure"]:
        # the shipped vocabulary unless the caller asks for online training
        online = kw.get("vocab_path") == "online"
        assert (slam.loop_closer is None) == online
        assert online or slam.loop_closer.vocab.n_words == 10_000
        assert (slam._lc_thread is not None) == (not kw.get("sequential", True))
    else:
        assert slam.loop_closer is None and slam._lc_thread is None
    slam.close()
    assert slam._map_thread is None and slam._lc_thread is None
    if "metrics_path" in kw:
        # opened by the constructor, closed by close()
        assert slam._metrics_f is None and os.path.exists(kw["metrics_path"])


def test_default_constructor_arguments_build_loop_closure():
    """SLAMSystem(fx, fy, cx, cy, W, H, cfg) and nothing else: loop closure
    on the shipped vocabulary, on the card (so only the device is named
    here, where there is none)."""
    from hslam_tpu_torch.models.system import SLAMSystem, default_vocab_path
    slam = SLAMSystem(80.0, 80.0, 63.5, 47.5, 128, 96, tcfg.Config(), device="cpu")
    assert slam.enable_loop_closure and slam.sequential
    assert default_vocab_path().endswith("vocab_10k.npz")
    assert slam.loop_closer.vocab.centroids.shape == (4, 10_000, 8)
    assert slam.loop_closer.min_gap == 10 and slam.loop_closer.consistency_th == 2
    assert slam.loop_closer.min_loop_error_rel == 1.0
    assert slam.n_loops_closed == 0 and slam.connectivity == {}
    slam.close()
