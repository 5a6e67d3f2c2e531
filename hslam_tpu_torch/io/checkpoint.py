"""Checkpoint / resume: the SLAM state in one .npz (port of
hslam_tpu/io/checkpoint.py).

The window, calibration, candidate (immature) state, stored features, host
policy mirrors, tracker template and the host shell history, under the JAX
package's key names (`window/.frames/.valid`, `template/.u/[0]`, the
`jax.tree_util` path strings) and dtypes (descriptor words as uint32), so a
checkpoint of either package restores into the other. Restoring goes
through `convert.from_numpy` and takes each leaf to the dtype of the
restoring system's own leaf.

Not saved, as in the JAX package: online photometric calibration, the loop
closer's database and vocabulary, the connectivity map, and anything of the
mapping thread (pending keyframe finalization, queued frames).
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .. import convert

_MIRRORS = ("_m_valid", "_m_kfid", "_m_t", "_m_aff", "_m_exp", "_m_nact_host", "_m_nimm_host")


def _named_leaves(tree, prefix):
    """(key, leaf) pairs of a structure of NamedTuples and lists, keyed as
    jax.tree_util.tree_flatten_with_path names them: '.field' for a
    NamedTuple field, '[i]' for a list entry; None leaves are skipped."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields for kv in _named_leaves(getattr(tree, f), f"{prefix}/.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree) for kv in _named_leaves(x, f"{prefix}/[{i}]")]
    return [(prefix, tree)]


def _rebuild(tree, prefix, data, device):
    """`tree`'s structure with every leaf read from `data` under its key,
    in that leaf's dtype, on `device`."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(**{f: _rebuild(getattr(tree, f), f"{prefix}/.{f}", data, device)
                             for f in tree._fields})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, f"{prefix}/[{i}]", data, device) for i, x in enumerate(tree))
    if tree is None:
        return None
    out = convert.from_numpy(data[prefix], device)
    return out.to(tree.dtype) if isinstance(tree, torch.Tensor) else out


def save_state(path: str, system) -> None:
    """Snapshot a models.system.SLAMSystem."""
    arrays: dict = {}
    for prefix, tree in (("window", system.window), ("immt", system.imm),
                         ("feats", system.feats), ("template", system.template)):
        arrays.update(_named_leaves(convert.to_numpy(tree), prefix))
    arrays["calib/value"] = system.calib.value.cpu().numpy()
    arrays["calib/value_zero"] = system.calib.value_zero.cpu().numpy()
    for name in _MIRRORS:
        arrays["mirror/" + name] = np.asarray(getattr(system, name))
    shells = [
        dict(id=s.id, timestamp=s.timestamp, exposure=s.exposure,
             cam_to_world=s.cam_to_world.tolist(), tracking_ref=s.tracking_ref,
             cam_to_ref=s.cam_to_ref.tolist(), aff=s.aff.tolist(),
             is_kf=s.is_kf, kf_id=s.kf_id, pose_valid=s.pose_valid)
        for s in system.shells
    ]
    meta = dict(
        shells=shells,
        slot_shell=system.slot_shell,
        initialized=system.initialized,
        frame_count=system.frame_count,
        next_kf_id=system.next_kf_id,
        kf_shell_ids=system.kf_shell_ids,
        current_min_act_dist=system.current_min_act_dist,
        last_coarse_rmse=np.asarray(system.last_coarse_rmse).tolist(),
        first_coarse_rmse=system.first_coarse_rmse,
        ref_slot=system.ref_slot,
        ref_shell_id=system.ref_shell_id,
        ref_aff=np.asarray(system.ref_aff).tolist(),
        ref_exposure=system.ref_exposure,
        calib_size=[system.width, system.height],
        marg_counts={str(k): v for k, v in system._marg_counts.items()},
    )
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_state(path: str, system) -> None:
    """Restore into an already constructed SLAMSystem of the same Config
    and image size, on that system's device."""
    from ..models.calib import k_pyr_from_value
    from ..models.system import Shell
    from ..ops import tracker as trk

    dev = system.device
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
    system.window = _rebuild(system.window, "window", data, dev)
    system.calib = system.calib._replace(
        value=convert.from_numpy(data["calib/value"], dev),
        value_zero=convert.from_numpy(data["calib/value_zero"], dev))
    # the calibration-derived per-level intrinsics the tracker reads
    system._K_pyr_cache = k_pyr_from_value(system.calib.value, system.cfg.pyr_levels)
    system.imm = _rebuild(system.imm, "immt", data, dev)
    if any(k.startswith("feats/") for k in data.files):
        system.feats = _rebuild(system.feats, "feats", data, dev)
    for name in _MIRRORS:
        if "mirror/" + name in data.files:
            setattr(system, name, np.asarray(data["mirror/" + name]))
    system._m_n_active = int(system._m_nact_host.sum())
    if any(k.startswith("template/") for k in data.files):
        # a fresh system has no template: its structure, one leaf per level
        n_lvl = system.cfg.pyr_levels
        like = system.template or trk.Template(
            *([torch.zeros(1, device=dev)] * n_lvl for _ in range(4)),
            valid=[torch.zeros(1, dtype=torch.bool, device=dev)] * n_lvl)
        system.template = _rebuild(like, "template", data, dev)

    system.shells = [
        Shell(id=s["id"], timestamp=s["timestamp"], exposure=s["exposure"],
              cam_to_world=np.array(s["cam_to_world"]), tracking_ref=s["tracking_ref"],
              cam_to_ref=np.array(s["cam_to_ref"]), aff=np.array(s["aff"]),
              is_kf=s["is_kf"], kf_id=s["kf_id"], pose_valid=s["pose_valid"])
        for s in meta["shells"]
    ]
    system.slot_shell = meta["slot_shell"]
    system.initialized = meta["initialized"]
    system.frame_count = meta["frame_count"]
    system.next_kf_id = meta["next_kf_id"]
    system.kf_shell_ids = meta["kf_shell_ids"]
    system.current_min_act_dist = meta["current_min_act_dist"]
    system.last_coarse_rmse = np.array(meta["last_coarse_rmse"])
    system.first_coarse_rmse = meta["first_coarse_rmse"]
    system.ref_slot = meta["ref_slot"]
    system.ref_shell_id = meta["ref_shell_id"]
    system.ref_aff = np.array(meta["ref_aff"])
    system.ref_exposure = meta["ref_exposure"]
    system._marg_counts = {int(k): v for k, v in meta["marg_counts"].items()}
