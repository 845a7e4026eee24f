"""Carry host state into the port and model tables onto the device.

No counterpart in rsem_tpu. Two jobs:

* `model_arrays_to_torch` turns GenerativeModel.device_arrays() (numpy)
  into float32 tensors on a device, as the TPU engine's `to_dev` did.
* `host_state` reduces a host object (a Reference, an AlignmentBundle, a
  GenerativeModel, ...) to plain nested dicts of numpy arrays and scalars,
  tagged with class names; `reference_from_arrays`, `bundle_from_arrays`
  and `model_from_arrays` rebuild the port's own objects from that. Both
  sides are duck-typed on attribute names, so a test can carry an object of
  the JAX package across without the port importing that package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .io.hits import CntStats, HitArrays
from .io.reads import PairedReadArrays, ReadArrays, ReadStats
from .io.sam import AlignmentBundle
from .model.generative import GenerativeModel
from .model.lendist import LenDist
from .model.noise import NoiseProfile, NoiseQProfile
from .model.orientation import Orientation
from .model.profile import Profile, QProfile
from .model.qualdist import QualDist
from .model.rspd import RSPD
from .model.spec import ModelSpec
from .refprep.reference import Reference
from .utils.device import to_device

CLASS_KEY = "__class__"
_PORT_CLASSES = {c.__name__: c for c in (
    Reference, AlignmentBundle, ReadArrays, PairedReadArrays, ReadStats,
    HitArrays, CntStats, GenerativeModel, ModelSpec, LenDist, RSPD, Profile,
    QProfile, QualDist, NoiseProfile, NoiseQProfile, Orientation,
)}


def model_arrays_to_torch(np_dict: Dict[str, np.ndarray],
                          device) -> Dict[str, torch.Tensor]:
    """GenerativeModel.device_arrays() -> float32 tensors on `device`."""
    return {k: to_device(np.asarray(v, dtype=np.float32), device)
            for k, v in np_dict.items()}


def host_state(obj):
    """Plain nested copy of a host object: numpy arrays, scalars, lists,
    dicts, and dicts tagged with CLASS_KEY for objects."""
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if obj is None or isinstance(obj, (bool, int, float, str, np.generic)):
        return obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_state(x) for x in obj)
    if isinstance(obj, dict):
        return {k: host_state(v) for k, v in obj.items()}
    out = {CLASS_KEY: type(obj).__name__}
    out.update({k: host_state(v) for k, v in vars(obj).items()})
    return out


def _rebuild(state):
    if isinstance(state, np.ndarray):
        return state.copy()
    if isinstance(state, (list, tuple)):
        return type(state)(_rebuild(x) for x in state)
    if isinstance(state, dict):
        if CLASS_KEY not in state:
            return {k: _rebuild(v) for k, v in state.items()}
        name = state[CLASS_KEY]
        if name not in _PORT_CLASSES:
            raise TypeError(f"no port counterpart for host class {name}")
        cls = _PORT_CLASSES[name]
        obj = cls.__new__(cls)
        for k, v in state.items():
            if k != CLASS_KEY:  # object.__setattr__: frozen dataclasses too
                object.__setattr__(obj, k, _rebuild(v))
        return obj
    return state


def _typed(state, name: str):
    if not isinstance(state, dict) or state.get(CLASS_KEY) != name:
        raise TypeError(f"expected the host state of a {name}")
    return _rebuild(state)


def reference_from_arrays(state) -> Reference:
    return _typed(state, "Reference")


def bundle_from_arrays(state) -> AlignmentBundle:
    return _typed(state, "AlignmentBundle")


def model_from_arrays(state, refs=None) -> GenerativeModel:
    """refs: the port's Reference to attach (else the one in `state`)."""
    model = _typed(state, "GenerativeModel")
    if refs is not None:
        model.refs = refs
    return model


def gibbs_state_from_jax(parts, zohs, tables, M: int):
    """The Gibbs state of the JAX package's tile sweep, in the port's form.

    parts: the JAX layout's parts (objects with `sid_t`, `cps_t`, `ncs_t`
    [X, 128] arrays and `K`); zohs: one-hot assignments per part [C, X, 128];
    tables: [C, t_pad, 128] counts + pseudo. Shape-menu padding tiles (no
    slot with a weight, always at a part's end) are cut off. Returns
    (list of ops.gibbs.GibbsPart, assign per part [C, n_reads] int32 with -1
    = noise, table [C, M+1] f32), all on the CPU."""
    from .ops.gibbs import TILE_ROWS, TILE_SLOTS, GibbsPart

    out_parts, assigns = [], []
    for p, z in zip(parts, zohs):
        K = int(p.K)
        cps = np.array(p.cps_t, dtype=np.float32)
        ncs_t = np.array(p.ncs_t, dtype=np.float32)
        real = ((cps > 0) | (ncs_t > 0)).reshape(-1, TILE_SLOTS).any(1)
        n_tiles = int(np.flatnonzero(real)[-1]) + 1 if real.any() else 0
        X = n_tiles * TILE_ROWS
        nr = n_tiles * (TILE_SLOTS // K)
        ncs = ncs_t[:X].reshape(nr, K)[:, 0]
        placed = ((cps[:X].reshape(nr, K) > 0).any(1) | (ncs > 0)).reshape(
            n_tiles, -1)
        # a tile's fill runs to its last placed read (JAX pads only the
        # bucket's last tile, at its end)
        fill = np.where(placed.any(1),
                        placed.shape[1] - placed[:, ::-1].argmax(1), 0)
        out_parts.append(GibbsPart(
            sid=torch.as_tensor(np.ascontiguousarray(
                np.array(p.sid_t, dtype=np.int32)[:X].reshape(-1))),
            cps=torch.as_tensor(np.ascontiguousarray(cps[:X].reshape(-1))),
            ncs=torch.as_tensor(np.ascontiguousarray(ncs)),
            K=K, n_tiles=n_tiles, fill=fill.astype(np.int64)))
        zr = np.asarray(z)[:, :X].reshape(z.shape[0], nr, K)
        a = np.where(zr.any(2), zr.argmax(2), -1).astype(np.int32)
        assigns.append(torch.as_tensor(a))
    t = np.array(tables, dtype=np.float32)
    table = torch.as_tensor(np.ascontiguousarray(
        t.reshape(t.shape[0], -1)[:, :M + 1]))
    return out_parts, assigns, table
