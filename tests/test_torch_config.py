"""hslam_tpu_torch: Config and constants equal the JAX package's; the port
imports no jax; unported options are refused, not silently skipped."""
import dataclasses
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


SLICE = dict(enable_indirect=False, init_direct_refine=False)


@pytest.mark.parametrize("kwargs", [
    dict(cfg=SLICE, enable_loop_closure=True),
    dict(cfg=SLICE, online_photo_calib=True),
    dict(cfg=SLICE, dist_mesh=object()),
    dict(cfg=SLICE, metrics_path="metrics.jsonl"),
], ids=["loop_closure", "photo_calib", "dist_mesh", "metrics_stream"])
def test_system_refuses_unported_options(kwargs):
    from hslam_tpu_torch.models.system import SLAMSystem
    kw = dict(enable_loop_closure=False)
    kw.update(kwargs)
    cfg = tcfg.Config(**kw.pop("cfg"))
    with pytest.raises(NotImplementedError):
        SLAMSystem(80.0, 80.0, 63.5, 47.5, 128, 96, cfg, device="cpu", **kw)


@pytest.mark.parametrize("kwargs", [
    dict(cfg=dict(enable_indirect=True, init_direct_refine=False)),
    dict(cfg=dict(enable_indirect=False, init_direct_refine=True)),
    dict(cfg=dict(SLICE, use_fast=True)),
    dict(cfg=SLICE, sequential=False),
], ids=["indirect", "init_refine", "use_fast", "pipelined"])
def test_system_accepts_ported_options(kwargs):
    """The ported options construct a system, which closes cleanly."""
    from hslam_tpu_torch.models.system import SLAMSystem
    kw = dict(enable_loop_closure=False)
    kw.update(kwargs)
    cfg = tcfg.Config(**kw.pop("cfg"))
    slam = SLAMSystem(80.0, 80.0, 63.5, 47.5, 128, 96, cfg, device="cpu", **kw)
    slam.close()
