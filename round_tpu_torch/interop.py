"""Carry the JAX package's arrays into the port's objects.

round_tpu hands its arrays over as numpy (``np.asarray`` of each field);
these functions turn such a dict into the port's dataclasses on an explicit
device, so both packages can run on the same data and be compared."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from round_tpu_torch.engine.fast import FaultMix
from round_tpu_torch.models.benor import BenOrState
from round_tpu_torch.models.erb import ErbState
from round_tpu_torch.models.floodmin import FloodMinState
from round_tpu_torch.models.lastvoting import LVState
from round_tpu_torch.models.lattice import LatticeState
from round_tpu_torch.models.otr import OtrState
from round_tpu_torch.models.tpc import TpcState
from round_tpu_torch.utils.device import resolve_device

_MIX_INT_FIELDS = ("crash_round", "side", "heal_round", "rotate_down", "p8",
                   "salt0", "salt1")


def _int32(a, dev) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)  # keep the bit pattern of uint32 salts
    return torch.as_tensor(arr.astype(np.int32), device=dev)


def _bool(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a).astype(bool), device=dev)


def fault_mix_from_numpy(d: Mapping[str, np.ndarray], device=None) -> FaultMix:
    """A FaultMix from numpy arrays named as round_tpu's FaultMix fields.
    The value-adversary fields are not ported and must be absent or None."""
    dev = resolve_device(device)
    for k in ("byz_value", "equiv_p8", "stale_p8"):
        if d.get(k) is not None:
            raise NotImplementedError(f"FaultMix.{k} is not ported")
    kw = {"crashed": _bool(d["crashed"], dev)}
    kw.update({k: _int32(d[k], dev) for k in _MIX_INT_FIELDS})
    return FaultMix(**kw)


def otr_state_from_numpy(d: Mapping[str, np.ndarray], device=None) -> OtrState:
    """An OtrState from numpy arrays named x, decided, decision, after."""
    dev = resolve_device(device)
    return OtrState(
        x=_int32(d["x"], dev),
        decided=_bool(d["decided"], dev),
        decision=_int32(d["decision"], dev),
        after=_int32(d["after"], dev),
    )


def floodmin_state_from_numpy(d: Mapping[str, np.ndarray],
                              device=None) -> FloodMinState:
    """A FloodMinState from numpy arrays named x, decided, decision."""
    dev = resolve_device(device)
    return FloodMinState(x=_int32(d["x"], dev), decided=_bool(d["decided"], dev),
                         decision=_int32(d["decision"], dev))


def benor_state_from_numpy(d: Mapping[str, np.ndarray],
                           device=None) -> BenOrState:
    """A BenOrState from numpy arrays named x, can_decide, vote, decided,
    decision (x, can_decide, decided and decision as bool)."""
    dev = resolve_device(device)
    return BenOrState(
        x=_bool(d["x"], dev),
        can_decide=_bool(d["can_decide"], dev),
        vote=_int32(d["vote"], dev),
        decided=_bool(d["decided"], dev),
        decision=_bool(d["decision"], dev),
    )


def lv_state_from_numpy(d: Mapping[str, np.ndarray], device=None) -> LVState:
    """An LVState from numpy arrays named x, ts, ready, commit, vote,
    decided, decision."""
    dev = resolve_device(device)
    return LVState(
        x=_int32(d["x"], dev),
        ts=_int32(d["ts"], dev),
        ready=_bool(d["ready"], dev),
        commit=_bool(d["commit"], dev),
        vote=_int32(d["vote"], dev),
        decided=_bool(d["decided"], dev),
        decision=_int32(d["decision"], dev),
    )


def tpc_state_from_numpy(d: Mapping[str, np.ndarray], device=None) -> TpcState:
    """A TpcState from numpy arrays named coord, vote, decision, decided."""
    dev = resolve_device(device)
    return TpcState(
        coord=_int32(d["coord"], dev),
        vote=_bool(d["vote"], dev),
        decision=_int32(d["decision"], dev),
        decided=_bool(d["decided"], dev),
    )


def erb_state_from_numpy(d: Mapping[str, np.ndarray], device=None) -> ErbState:
    """An ErbState from numpy arrays named x_val, x_def, delivered,
    delivery."""
    dev = resolve_device(device)
    return ErbState(
        x_val=_int32(d["x_val"], dev),
        x_def=_bool(d["x_def"], dev),
        delivered=_bool(d["delivered"], dev),
        delivery=_int32(d["delivery"], dev),
    )


def lattice_state_from_numpy(d: Mapping[str, np.ndarray],
                             device=None) -> LatticeState:
    """A LatticeState from numpy arrays named active, proposed ([.., m]),
    decided, decision ([.., m]), all bool."""
    dev = resolve_device(device)
    return LatticeState(**{k: _bool(d[k], dev) for k in
                           ("active", "proposed", "decided", "decision")})
