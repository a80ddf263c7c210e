"""Lie models: how a value adversary forges one round payload.

Port of round_tpu/byz/lies.py.  A lie model is ONE pure function

    lie(k, payload, v) -> forged payload (same pytree structure/shapes)

where ``k`` is the static round-class index (``r % rounds_per_phase``),
``payload`` is a SINGLE sender's payload pytree for that class (per-lane
shapes: scalars for OTR/LastVoting, dicts for the PBFT family) and ``v``
is the claimed value (a scalar tensor or an int).  The engine applies it
under ``torch.func.vmap`` over (receiver, sender) (byz/adversary.py
``ValueAdversary``): equivocation is just a different ``v`` per
destination in the same round.  ``forge_payload`` is the same function on
a decoded host payload of numpy leaves.

The default ``generic_lie`` claims ``v`` in every leaf (ints -> v, bools
-> v mod 2): corrupted but well-formed.  The PBFT forgeries ship the
digest of the lie (``models.pbft.digest``), so the lie survives the
receiver's digest recheck instead of degrading to an omission.

Everything here stays vmap-safe: torch ops only, Python dispatch only on
the static ``k``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from round_tpu_torch.utils.tree import tree_map

LieFn = Callable[[int, Any, Any], Any]


def _claim(leaf, v) -> torch.Tensor:
    """One leaf claiming value ``v``: dtype/shape-preserving broadcast
    (round_tpu/byz/lies.py::_claim).  Bools take ``v mod 2``; every other
    dtype a wrapping cast."""
    leaf = torch.as_tensor(leaf)
    v = torch.as_tensor(v, device=leaf.device)
    if leaf.dtype == torch.bool:
        out = (v.to(torch.int32) % 2).to(torch.bool)
    else:
        out = v.to(leaf.dtype)
    return out.expand(leaf.shape)


def _true_like(leaf) -> torch.Tensor:
    leaf = torch.as_tensor(leaf)
    return torch.ones((), dtype=torch.bool, device=leaf.device).expand(
        leaf.shape)


def generic_lie(k: int, payload: Any, v) -> Any:
    """Claim ``v`` in every leaf of the payload, the protocol-agnostic
    forgery (round_tpu/byz/lies.py::generic_lie).  For value-broadcast
    protocols (OTR's x, LastVoting's vote/x rounds) this is the classic
    equivocation: different destinations hear different well-formed
    values."""
    del k
    return tree_map(lambda leaf: _claim(leaf, v), payload)


def pbft_lie(k: int, payload: Any, v) -> Any:
    """Digest-consistent forgery for the 3-round Bcp (models/pbft.py;
    round_tpu/byz/lies.py::pbft_lie): the lied request ships with the
    digest of the lie, so the receiver's recheck passes and the lie enters
    the quorum counting."""
    from round_tpu_torch.models.pbft import digest

    v32 = torch.as_tensor(v).to(torch.int32)
    if k == 0:  # pre-prepare: {"req", "dig"}
        return {"req": _claim(payload["req"], v32),
                "dig": _claim(payload["dig"], digest(v32))}
    if k == 1:  # prepare: {"dig", "ok"}: a valid matching digest
        return {"dig": _claim(payload["dig"], digest(v32)),
                "ok": _true_like(payload["ok"])}
    # commit: bare digest scalar
    return _claim(payload, digest(v32))


def pbft_vc_lie(k: int, payload: Any, v) -> Any:
    """The PbftViewChange forgery, 6-round phases
    (round_tpu/byz/lies.py::pbft_vc_lie).  View and next-view fields stay
    truthful: a lied view fails the receivers' same-view filters and
    collapses to an omission; this adversary lies about the value while
    staying protocol-coherent."""
    from round_tpu_torch.models.pbft import digest

    v32 = torch.as_tensor(v).to(torch.int32)
    if k == 0:  # pre-prepare: {"req", "dig", "view"}
        return {"req": _claim(payload["req"], v32),
                "dig": _claim(payload["dig"], digest(v32)),
                "view": payload["view"]}
    if k == 1:  # prepare: {"dig", "ok", "view"}
        return {"dig": _claim(payload["dig"], digest(v32)),
                "ok": _true_like(payload["ok"]),
                "view": payload["view"]}
    if k == 2:  # commit: {"dig", "view"}
        return {"dig": _claim(payload["dig"], digest(v32)),
                "view": payload["view"]}
    if k == 3:  # view-change: {"nv", "pr", "pv"}, a forged certificate
        return {"nv": payload["nv"],
                "pr": _claim(payload["pr"], v32),
                "pv": payload["pv"]}
    if k == 4:  # view-change-ack: {"nv", "ackd"}, garbage ack digests
        return {"nv": payload["nv"],
                "ackd": _claim(payload["ackd"], digest(v32))}
    # new-view: {"nv", "sel"}, the equivocating new primary
    return {"nv": payload["nv"], "sel": _claim(payload["sel"], v32)}


#: protocol (selector name) -> lie model; anything absent gets the
#: generic value-claim forgery (round_tpu/byz/lies.py::LIE_MODELS)
LIE_MODELS: Dict[str, LieFn] = {
    "pbft": pbft_lie,
    "pbft-vc": pbft_vc_lie,
    "pbftvc": pbft_vc_lie,
}


def lie_for(protocol: str) -> LieFn:
    """The protocol's lie model (round_tpu/byz/lies.py::lie_for)."""
    return LIE_MODELS.get((protocol or "").lower(), generic_lie)


def forge_payload(protocol: str, k: int, payload: Any, v: int) -> Any:
    """Host-side forgery: the protocol's lie model applied to a decoded
    payload of numpy leaves, returned as numpy leaves with the original
    dtypes and shapes (round_tpu/byz/lies.py::forge_payload)."""
    tpayload = tree_map(lambda leaf: torch.as_tensor(np.asarray(leaf)),
                        payload)
    lied = lie_for(protocol)(k, tpayload, int(v))
    return tree_map(
        lambda orig, new: np.asarray(new.cpu()).astype(
            np.asarray(orig).dtype, copy=False).reshape(np.shape(orig)),
        payload, lied)
