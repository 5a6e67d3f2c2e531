"""Carry state between the JAX package and the port.

`from_numpy(tree, device)` turns the JAX package's state (Window, Frames,
Points, Imm, TraceState, Template, Calib, Feats, ... as nested NamedTuples
of numpy arrays, e.g. after `jax.device_get`) into the port's structures of
the same name, field by field; `to_numpy` goes the other way, to nested
NamedTuples of numpy arrays. No jax import: the JAX side hands over numpy.

Descriptors: the JAX package stores rBRIEF words as uint32, the port as
int32 with the same bits (ops/orb.py). uint32 arrays therefore cross as a
`.view(np.int32)`, and `to_numpy` gives Feats.desc and Vocabulary.centroids
back as uint32, so a round trip is bit-exact.

Photometric calibration: PhotoParams crosses like the state, so a parity
test can start the port's warm refit from the JAX package's parameters.

The global BA's problem (GlobalBA) crosses like the PoseGraph: its index
arrays are int32 in the JAX package and int64 in the port.

Loop closure: a Vocabulary and a PoseGraph cross like any other structure
(the vocabulary's k, levels and n_words are plain ints). The loop closer's
database is a list of KeyframeEntry dataclasses of numpy arrays on both
sides; `entries_from_numpy` and `entries_to_numpy` carry such a list
across, so both packages can start a parity test from one database.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models import calib as _calib
from .models import kf_step as _ks
from .models import loop_closure as _lc
from .models import optimizer as _opt
from .models import photo_calib as _pc
from .models import pose_graph as _pg
from .models import window as _w
from .ops import ba as _ba
from .ops import bow as _bow
from .ops import epipolar as _epi
from .ops import features as _ft
from .ops import tracker as _trk
from .parallel import global_ba as _gba

_PORT_TYPES = {cls.__name__: cls for cls in (
    _w.Window, _w.Frames, _w.Points, _ks.Imm, _ks.KFBundle, _epi.TraceState,
    _trk.Template, _trk.TrackResult, _calib.Calib, _ft.Feats,
    _ba.Linearization, _ba.GNSystem, _ba.FrozenResiduals, _opt.BAResult,
    _bow.Vocabulary, _pg.PoseGraph, _pc.PhotoParams, _gba.GlobalBA)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def from_numpy(tree, device="cuda"):
    if _is_namedtuple(tree):
        cls = _PORT_TYPES.get(type(tree).__name__)
        if cls is None:
            raise TypeError(f"no port structure named {type(tree).__name__}")
        # a field the other package's structure lacks keeps its default
        out = cls(**{k: from_numpy(getattr(tree, k), device) for k in cls._fields
                     if hasattr(tree, k)})
        if cls is _pg.PoseGraph:      # the port indexes with int64
            out = out._replace(edge_i=out.edge_i.long(), edge_j=out.edge_j.long())
        if cls is _gba.GlobalBA:
            out = out._replace(host=out.host.long(), obs_p=out.obs_p.long(),
                               obs_t=out.obs_t.long())
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(x, device) for x in tree)
    if tree is None or (isinstance(tree, (bool, int, float)) and not isinstance(tree, np.generic)):
        return tree
    arr = np.asarray(tree)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def to_numpy(tree):
    if isinstance(tree, _gba.GlobalBA):
        out = _gba.GlobalBA(**{k: to_numpy(getattr(tree, k)) for k in tree._fields})
        return out._replace(host=out.host.astype(np.int32), obs_p=out.obs_p.astype(np.int32),
                            obs_t=out.obs_t.astype(np.int32))
    if isinstance(tree, (_ft.Feats, _bow.Vocabulary, _pg.PoseGraph)):
        out = type(tree)(**{k: to_numpy(getattr(tree, k)) for k in tree._fields})
        if isinstance(tree, _ft.Feats):
            return out._replace(desc=out.desc.view(np.uint32))
        if isinstance(tree, _bow.Vocabulary):
            return out._replace(centroids=out.centroids.view(np.uint32))
        return out._replace(edge_i=out.edge_i.astype(np.int32),
                            edge_j=out.edge_j.astype(np.int32))
    if _is_namedtuple(tree):
        return type(tree)(**{k: to_numpy(getattr(tree, k)) for k in tree._fields})
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(x) for x in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def entries_from_numpy(entries) -> list:
    """A loop-closure database (KeyframeEntry records of numpy arrays, of
    either package) as the port's KeyframeEntry list: copies, descriptors
    as int32 words."""
    out = []
    for e in entries:
        kw = {f.name: getattr(e, f.name) for f in dataclasses.fields(_lc.KeyframeEntry)}
        kw = {k: (np.array(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        if kw["desc"].dtype == np.uint32:
            kw["desc"] = kw["desc"].view(np.int32)
        out.append(_lc.KeyframeEntry(**kw))
    return out


def entries_to_numpy(entries) -> list:
    """The port's KeyframeEntry list as dicts of the JAX package's
    KeyframeEntry fields (descriptors as uint32), for `KeyframeEntry(**d)`
    on that side."""
    out = []
    for e in entries:
        d = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
             for k, v in dataclasses.asdict(e).items()}
        if d["desc"].dtype == np.int32:
            d["desc"] = d["desc"].view(np.uint32)
        out.append(d)
    return out
