"""Carry the JAX package's arrays and records into the port's objects.

round_tpu hands its arrays over as numpy (``np.asarray`` of each field);
these functions turn such a dict into the port's dataclasses on an explicit
device, so both packages can run on the same data and be compared.  The
runtime's durable state crosses too: a decision log as its (instance,
round, value) triples, and a checkpoint directory that round_tpu wrote
(``checkpoint_from_round_tpu``, ``smr_from_round_tpu``)."""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Tuple

import numpy as np
import torch

from round_tpu_torch.engine.fast import FaultMix
from round_tpu_torch.models.benor import BenOrState
from round_tpu_torch.models.erb import ErbState
from round_tpu_torch.models.failure_detector import EsfdState
from round_tpu_torch.models.floodmin import FloodMinState
from round_tpu_torch.models.gameoflife import CgolState
from round_tpu_torch.models.kset import KSetESState, KSetState
from round_tpu_torch.models.lastvoting import LVState
from round_tpu_torch.models.lattice import LatticeState
from round_tpu_torch.models.mutex import MutexState
from round_tpu_torch.models.otr import OtrState
from round_tpu_torch.models.pbft import BcpState, PbftVcState
from round_tpu_torch.models.theta import ThetaState
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
    """A FaultMix from numpy arrays named as round_tpu's FaultMix fields;
    the value-adversary fields (byz_value, equiv_p8, stale_p8) are carried
    where present and not None."""
    dev = resolve_device(device)
    kw = {"crashed": _bool(d["crashed"], dev)}
    kw.update({k: _int32(d[k], dev) for k in _MIX_INT_FIELDS})
    if d.get("byz_value") is not None:
        kw["byz_value"] = _bool(d["byz_value"], dev)
    for k in ("equiv_p8", "stale_p8"):
        if d.get(k) is not None:
            kw[k] = _int32(d[k], dev)
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


def _fields(cls, d: Mapping[str, np.ndarray], dev, bools) -> object:
    """cls from numpy arrays named as its fields: the names in `bools` as
    bool, every other as int32 (uint32 bit patterns kept)."""
    import dataclasses

    return cls(**{f.name: (_bool if f.name in bools else _int32)(
        d[f.name], dev) for f in dataclasses.fields(cls)})


def kset_es_state_from_numpy(d: Mapping[str, np.ndarray],
                             device=None) -> KSetESState:
    """A KSetESState from numpy arrays named est, can_decide, last_nb,
    decided, decision."""
    return _fields(KSetESState, d, resolve_device(device),
                   ("can_decide", "decided"))


def kset_state_from_numpy(d: Mapping[str, np.ndarray],
                          device=None) -> KSetState:
    """A KSetState from numpy arrays named t_vals, t_mask ([.., n] each),
    decider, decided, decision."""
    return _fields(KSetState, d, resolve_device(device),
                   ("t_mask", "decider", "decided"))


def esfd_state_from_numpy(d: Mapping[str, np.ndarray],
                          device=None) -> EsfdState:
    """An EsfdState from a numpy array named last_seen ([.., n])."""
    return _fields(EsfdState, d, resolve_device(device), ())


def theta_state_from_numpy(d: Mapping[str, np.ndarray],
                           device=None) -> ThetaState:
    """A ThetaState from numpy arrays named round, next_round_at, heard
    ([.., n])."""
    return _fields(ThetaState, d, resolve_device(device), ())


def bcp_state_from_numpy(d: Mapping[str, np.ndarray],
                         device=None) -> BcpState:
    """A BcpState (PBFT) from numpy arrays named x, dig, valid, prepared,
    decided, decision."""
    return _fields(BcpState, d, resolve_device(device),
                   ("valid", "prepared", "decided"))


def pbft_vc_state_from_numpy(d: Mapping[str, np.ndarray],
                             device=None) -> PbftVcState:
    """A PbftVcState from numpy arrays named as its sixteen fields
    (vc_heard, vc_req and vc_pv [.., n] each)."""
    return _fields(PbftVcState, d, resolve_device(device),
                   ("valid", "prepared", "decided", "vc_active", "vc_heard",
                    "nv_ok"))


def mutex_state_from_numpy(d: Mapping[str, np.ndarray],
                           device=None) -> MutexState:
    """A MutexState from numpy arrays named x, has_token."""
    return _fields(MutexState, d, resolve_device(device), ("has_token",))


def cgol_state_from_numpy(d: Mapping[str, np.ndarray],
                          device=None) -> CgolState:
    """A CgolState from a numpy array named alive."""
    return _fields(CgolState, d, resolve_device(device), ("alive",))


def decision_log_from_round_tpu(triples: Iterable[Tuple[int, int, int]]):
    """A port DecisionLog from round_tpu's (instance, round, value)
    triples (``[(i, *log.get(i)) for i in log.instances()]``): the same
    ``values_tsv`` bytes and ``digest``."""
    from round_tpu_torch.runtime.decisions import DecisionLog

    log = DecisionLog()
    for inst, rnd, val in triples:
        log.record(int(inst), int(rnd), int(val))
    return log


def checkpoint_from_round_tpu(path: str, like: Any):
    """Restore a checkpoint directory that round_tpu wrote
    (round_tpu/runtime/checkpoint.py::save) into the structure of ``like``.
    Returns (state, step, meta), the leaves numpy arrays.

    round_tpu's manifest records a JAX tree-structure string the port
    cannot read, so the leaves are held against ``like`` one by one
    instead: the leaf count, then each leaf's dtype and shape (a
    zero-length dimension of a ``like`` leaf stands for any length, as in
    a log of K rows).  A mismatch raises CheckpointError, as a corrupt
    checkpoint does."""
    from round_tpu_torch.runtime import checkpoint as ckpt
    from round_tpu_torch.utils.tree import tree_flatten

    leaves, manifest = ckpt.read_leaves(path)
    like_leaves, spec = tree_flatten(like)
    ckpt.check_leaf_count(leaves, like_leaves)
    for i, (got, want) in enumerate(zip(leaves, like_leaves)):
        want = ckpt.to_numpy(want)
        fits = got.ndim == want.ndim and all(
            w == 0 or g == w for g, w in zip(got.shape, want.shape))
        if got.dtype != want.dtype or not fits:
            raise ckpt._corruption(
                f"checkpoint leaf {i} does not match the restore template: "
                f"saved {got.dtype}{list(got.shape)}, template "
                f"{want.dtype}{list(want.shape)}")
    return ckpt.restored(path, leaves, spec, manifest)


def smr_from_round_tpu(rsm, path: str) -> int:
    """Rebuild a port ReplicatedStateMachine ``rsm`` from an SMR checkpoint
    that round_tpu wrote (round_tpu/runtime/smr.py::checkpoint), as
    ``rsm.restore_checkpoint`` does from the port's own.  Returns the
    applied-upto watermark."""
    return rsm._adopt_checkpoint(
        path, *checkpoint_from_round_tpu(path, rsm._checkpoint_like()))


def formula_from_round_tpu(f: Any) -> Any:
    """Rebuild a round_tpu verifier object in the port's classes: a
    ``Formula`` tree, a ``Type``, a ``Symbol``, a ``ClConfig``, or a ``VC``
    tree (``SingleVC``/``CompositeVC``); a list or tuple of them maps
    element-wise.  The walk goes by class name and fields (duck-typed, so
    this package never imports round_tpu), keeps every node's type, and
    maps each of the reference's type variables to one fresh type variable
    of the port, so that the same formula can be handed to both solvers."""
    from round_tpu_torch.verify import cl, formula, vc

    return carry_formula(f, formula, vc, cl.ClConfig)


def carry_formula(f: Any, F, V, config_cls) -> Any:
    """The walk of ``formula_from_round_tpu`` into the classes of any
    package laid out as ``verify/``: its ``formula`` module ``F``, its
    ``vc`` module ``V`` and its ``ClConfig`` class (so a test can also
    carry the port's objects back into round_tpu's)."""
    import dataclasses

    tvars: dict = {}

    def typ(t):
        if t is None:
            return None
        k = type(t).__name__
        if k == "BoolT":
            return F.Bool
        if k == "IntT":
            return F.Int
        if k == "Wildcard":
            return F.Wildcard()
        if k == "TVar":
            if t.index not in tvars:
                tvars[t.index] = F.fresh_tvar()
            return tvars[t.index]
        if k == "UnInterpreted":
            return F.UnInterpreted(t.name)
        if k in ("FSet", "FOption"):
            return getattr(F, k)(typ(t.elem))
        if k == "FMap":
            return F.FMap(typ(t.key), typ(t.value))
        if k == "Product":
            return F.Product([typ(a) for a in t.args])
        if k == "FunT":
            return F.FunT([typ(a) for a in t.args], typ(t.ret))
        raise TypeError(f"cannot carry type {t!r} ({k}) over")

    def sym(s):
        k = type(s).__name__
        if k == "InterpretedFct":
            return F.SYMBOL_BY_NAME[s.name]
        if k == "UnInterpretedFct":
            return F.UnInterpretedFct(s.name, typ(s.tpe))
        raise TypeError(f"cannot carry symbol {s!r} ({k}) over")

    memo: dict = {}

    def form(x):
        key = id(x)
        if key in memo:
            return memo[key][1]
        k = type(x).__name__
        if k == "Literal":
            out = F.Literal(x.value)
        elif k == "Variable":
            out = F.Variable(x.name, typ(x.tpe))
        elif k == "Application":
            out = F.Application(sym(x.fct), [form(a) for a in x.args])
        elif k == "Binding":
            out = F.Binding(x.binder, [form(v) for v in x.vars], form(x.body))
        else:
            raise TypeError(f"cannot carry formula node {x!r} ({k}) over")
        if k != "Literal":
            out.tpe = typ(x.tpe)
        memo[key] = (x, out)  # keep x alive so its id is not reused
        return out

    def config(c):
        if c is None:
            return None
        vals = {fd.name: getattr(c, fd.name)
                for fd in dataclasses.fields(config_cls)}
        if vals.get("tactic") is not None or vals.get("qi_logger") is not None:
            raise TypeError("cannot carry a ClConfig with a tactic or a "
                            "QI logger over")
        return config_cls(**vals)

    def walk(x):
        k = type(x).__name__
        if isinstance(x, (list, tuple)):
            return type(x)(walk(y) for y in x)
        if k in ("Literal", "Variable", "Application", "Binding"):
            return form(x)
        if k in ("BoolT", "IntT", "Wildcard", "TVar", "UnInterpreted",
                 "FSet", "FOption", "FMap", "Product", "FunT"):
            return typ(x)
        if k in ("InterpretedFct", "UnInterpretedFct"):
            return sym(x)
        if k == "ClConfig":
            return config(x)
        if k == "SingleVC":
            return V.SingleVC(x.name, form(x.hypothesis),
                              form(x.transition), form(x.conclusion),
                              config(x.config), x.timeout_s)
        if k == "CompositeVC":
            return V.CompositeVC(x.name, x.all_of,
                                 [walk(c) for c in x.children])
        raise TypeError(f"cannot carry {x!r} ({k}) over")

    return walk(f)
