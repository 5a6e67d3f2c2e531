"""Carry state between the JAX package and the port.

`from_numpy(tree, device)` turns the JAX package's state (Window, Frames,
Points, Imm, TraceState, Template, Calib, Feats, ... as nested NamedTuples
of numpy arrays, e.g. after `jax.device_get`) into the port's structures of
the same name, field by field; `to_numpy` goes the other way, to nested
NamedTuples of numpy arrays. No jax import: the JAX side hands over numpy.

Descriptors: the JAX package stores rBRIEF words as uint32, the port as
int32 with the same bits (ops/orb.py). uint32 arrays therefore cross as a
`.view(np.int32)`, and `to_numpy` gives Feats.desc back as uint32, so a
round trip is bit-exact.
"""
from __future__ import annotations

import numpy as np
import torch

from .models import calib as _calib
from .models import kf_step as _ks
from .models import optimizer as _opt
from .models import window as _w
from .ops import ba as _ba
from .ops import epipolar as _epi
from .ops import features as _ft
from .ops import tracker as _trk

_PORT_TYPES = {cls.__name__: cls for cls in (
    _w.Window, _w.Frames, _w.Points, _ks.Imm, _ks.KFBundle, _epi.TraceState,
    _trk.Template, _trk.TrackResult, _calib.Calib, _ft.Feats,
    _ba.Linearization, _ba.GNSystem, _ba.FrozenResiduals, _opt.BAResult)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def from_numpy(tree, device="cpu"):
    if _is_namedtuple(tree):
        cls = _PORT_TYPES.get(type(tree).__name__)
        if cls is None:
            raise TypeError(f"no port structure named {type(tree).__name__}")
        return cls(**{k: from_numpy(getattr(tree, k), device) for k in cls._fields})
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(x, device) for x in tree)
    if isinstance(tree, (bool, int, float)) and not isinstance(tree, np.generic):
        return tree
    arr = np.asarray(tree)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def to_numpy(tree):
    if isinstance(tree, _ft.Feats):
        out = type(tree)(**{k: to_numpy(getattr(tree, k)) for k in tree._fields})
        return out._replace(desc=out.desc.view(np.uint32))
    if _is_namedtuple(tree):
        return type(tree)(**{k: to_numpy(getattr(tree, k)) for k in tree._fields})
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(x) for x in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree
