"""The count-rank ε-agreement engine: order statistics without a sort.

Port of round_tpu/engine/epsfast.py.  ε-agreement's update sorts each
receiver's multiset V_j = mailbox_j ∪ halted_j (models/epsilon.py).  One
observation removes the sort: a halting process broadcasts its halt value
exactly once (it exits at the end of its deciding round), so the value a
receiver stores for a halted peer is the same at every receiver, and only
the halted *mask* is per-receiver.  Every V_j is then a masked view of one
shared [2n] vector V = [x ; H] (estimates; halt values), and every order
statistic the update needs is a threshold count:

  rank of V[l] in V_j  =  C[j,l] = Σ_i members[j,i] · (V[i] ≤ V[l])

— two 0/1 products per scenario, batched over scenarios as [S, n, 2n].
The k-th order statistic is min{ V[l] : l ∈ V_j, C[j,l] ≥ k+1 }.

The products run as float32 ``torch.bmm`` of 0/1 operands: every partial
sum is an integer ≤ 2n, exact in float32 (and under TF32, whose inputs
hold 0 and 1 exactly).  Never a float16 or bfloat16 output: counts past
256 would round, and the engine would be wrong rather than slow.

Bit parity with the general engine (engine/executor.run_instance over
models/epsilon.py) holds by construction: selections, minima and maxima
do no rounding, the horizon goes through the same ``horizon`` function,
and the trimmed mean sums the same zero-padded [2n] layout through
ops.detsum.tree_sum.  round_tpu runs these products as int8 MXU matmuls;
this package has no kernel of its own here (round_tpu has no Pallas
kernel here either).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Sequence

import torch

from round_tpu_torch.engine.executor import RunResult
from round_tpu_torch.models.epsilon import (
    EpsilonConsensus, EpsilonState, horizon,
)
from round_tpu_torch.ops.detsum import tree_sum
from round_tpu_torch.utils.device import resolve_device

_INF = float("inf")
_INT32_MAX = 2**31 - 1


def _count_ranks(present, hmask, x, hvals):
    """(V [S, 2n], C [S, n, 2n]) with C[s,j,l] = |{ i ∈ V_j : V[i] ≤ V[l] }|
    (round_tpu/engine/epsfast.py::_count_ranks): one product for the
    mailbox members and one for the halted members, so each comparison
    operand stays [S, n, 2n].  C holds exact integers in float32."""
    V = torch.cat([x, hvals], dim=1)
    b_mail = (x[:, :, None] <= V[:, None, :]).to(torch.float32)
    C = torch.bmm(present.to(torch.float32), b_mail)
    del b_mail
    b_halt = (hvals[:, :, None] <= V[:, None, :]).to(torch.float32)
    C += torch.bmm(hmask.to(torch.float32), b_halt)
    return V, C


def _rank_val(V, members, C, k: int):
    """k-th (0-indexed) order statistic of V_j for every receiver j:
    min{ V[l] : members[j,l] ∧ C[j,l] ≥ k+1 }; +inf where V_j has no k-th
    element (round_tpu/engine/epsfast.py::_rank_val)."""
    ok = members & (C >= k + 1)
    return torch.where(ok, V[:, None, :], _INF).amin(dim=2)


def run_epsilon_batch(algo: EpsilonConsensus, x0: torch.Tensor,
                      keys: Sequence[Any], ho_sampler: Callable,
                      max_phases: int) -> RunResult:
    """S scenarios at once: ``x0`` [S, n] float32 initial values, ``keys``
    S ``(salt0, salt1)`` scenario keys.  Scenario s's masks are
    ``ho_sampler(keys[s], r)``, its key handed unchanged as the general
    engine does (round_tpu splits the key first; its draws are never
    bit-compared).  Runs on x0's device; every state leaf is [S, n, ...]."""
    rnd = algo.rounds[0]
    f, eps, c = rnd.f, rnd.epsilon, rnd.c
    x = torch.as_tensor(x0).to(torch.float32)
    S, n = x.shape
    assert rnd.n == n and len(keys) == S
    dev = x.device
    # rank schedule of the convergence step: f + 2f·i (models/epsilon.py);
    # at most m_max of them can be valid (idx < cnt - f ≤ 2n - f)
    m_max = max(1, -(-(2 * n - f) // (2 * f)))
    ks = f + 2 * f * torch.arange(m_max, device=dev)

    max_r = torch.full((S, n), _INT32_MAX, dtype=torch.int32, device=dev)
    hvals = torch.zeros((S, n), dtype=torch.float32, device=dev)
    hmask = torch.zeros((S, n, n), dtype=torch.bool, device=dev)
    decided = torch.zeros((S, n), dtype=torch.bool, device=dev)
    decision = torch.full((S, n), math.nan, dtype=torch.float32, device=dev)
    done = torch.zeros((S, n), dtype=torch.bool, device=dev)
    dround = torch.full((S, n), -1, dtype=torch.int32, device=dev)

    for r in range(max_phases):
        active = ~done
        ho = torch.stack([ho_sampler(k, r) for k in keys]).to(dev)
        halt_flag = (r > max_r) & active               # sender's halt bit
        present = ho & active[:, None, :]              # mailbox mask
        members = torch.cat([present, hmask], dim=2)   # [S, n, 2n]

        V, C = _count_ranks(present, hmask, x, hvals)
        cnt = members.sum(dim=2, dtype=torch.int32)
        vm = torch.where(members, V[:, None, :], _INF).amin(dim=2)
        vM = torch.where(members, V[:, None, :], -_INF).amax(dim=2)
        max_r0 = horizon(vM - vm, eps, c)
        x_r0 = _rank_val(V, members, C, 2 * f)         # sorted[2f]

        # the convergence step: mean of sorted[f + 2f·i] for idx < cnt - f.
        # The rank values land at positions 0..m-1 of a [2n] zero vector,
        # the layout the general engine sums, one rank at a time (each
        # _rank_val is an [S, n, 2n] temporary); ranks no lane can use
        # this round stay zero
        valid = ks[None, None, :] < (cnt - f)[..., None]   # [S, n, m]
        sel = torch.zeros((S, n, 2 * n), dtype=torch.float32, device=dev)
        k_hi = int(cnt.max()) - f
        for i, k in enumerate(ks.tolist()):
            if k >= k_hi:
                break
            sel[..., i] = torch.where(valid[..., i],
                                      _rank_val(V, members, C, k), 0.0)
        del C
        n_valid = valid.sum(dim=2, dtype=torch.int32)
        x_mid = tree_sum(sel, dim=-1) / torch.clamp(n_valid, min=1)
        del sel

        if r == 0:
            deciding = torch.zeros_like(active)
            x_new, max_r_new = x_r0, max_r0
        else:
            over = r > max_r
            deciding = over & active
            x_new, max_r_new = torch.where(over, x, x_mid), max_r

        # deciding lanes are active: the frozen lanes keep their state (the
        # general engine's tree_where), and a decision is the estimate
        # before the update
        decision = torch.where(deciding & ~decided, x, decision)
        decided = decided | deciding
        done = done | deciding
        hmask = torch.where(active[..., None],
                            hmask | (present & halt_flag[:, None, :]), hmask)
        hvals = torch.where(halt_flag, x, hvals)  # shared: active writers
        x = torch.where(active, x_new, x)
        max_r = torch.where(active, max_r_new, max_r)
        dround = torch.where(decided & (dround < 0), r, dround)

    state = EpsilonState(
        x=x, max_r=max_r,
        halted_vals=torch.where(hmask, hvals[:, None, :], 0.0),
        halted_mask=hmask, decided=decided, decision=decision,
    )
    return RunResult(state=state, done=done, decided_round=dround,
                     rounds_run=max_phases)


def run_epsilon_fast(algo: EpsilonConsensus, io: Any, n: int, key,
                     ho_sampler: Callable, max_phases: int,
                     device=None) -> RunResult:
    """Drop-in run_instance replacement for EpsilonConsensus, one scenario
    (round_tpu/engine/epsfast.py::run_epsilon_fast): ``key`` is the
    scenario's ``(salt0, salt1)``, masks are ``ho_sampler(key, r)``.
    Every state leaf is [n, ...]; run_epsilon_batch runs S at once."""
    dev = resolve_device(device)
    x0 = torch.as_tensor(io["initial_value"], device=dev)
    assert x0.shape == (n,), x0.shape
    res = run_epsilon_batch(algo, x0[None], [key], ho_sampler, max_phases)
    return RunResult(
        state=EpsilonState(**{k: getattr(res.state, k)[0] for k in (
            "x", "max_r", "halted_vals", "halted_mask", "decided",
            "decision")}),
        done=res.done[0], decided_round=res.decided_round[0],
        rounds_run=max_phases)
