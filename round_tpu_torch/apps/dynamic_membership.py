"""Membership changes decided by consensus.

Port of round_tpu/apps/dynamic_membership.py.  Reference parity:
example/DynamicMembership.scala:231-245 — the group votes on a
MembershipOp (add/remove replica); once consensus decides, the Directory
is mutated, ids are renamed to stay contiguous (Replicas.scala:136-142),
the runtime group is swapped (Runtime.scala:26-28), and subsequent
instances run over the new group.  Here "swapping the group" = later
instances run with the new n; there are no sockets to rewire.  The op
encoding is runtime/view.py's: kind * 2^24 + arg (1=add(port),
2=remove(pid)).

The consensus runs on ``device`` (the card unless the caller passes
another).  round_tpu's ``PRNGKey(23)`` is the key ``(0, 23)``, and
instance i runs under ``instance_key((0, 23), i)`` (runtime/instances.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from round_tpu_torch.apps.selector import select
from round_tpu_torch.engine import scenarios
from round_tpu_torch.models.common import consensus_io
from round_tpu_torch.runtime.instances import InstancePool, instance_key
from round_tpu_torch.runtime.membership import Directory
from round_tpu_torch.runtime.view import (  # noqa: F401
    ADD, REMOVE, decode, encode,
)
from round_tpu_torch.utils.device import resolve_device


class MembershipManager:
    """Runs consensus-on-membership over the current view and applies the
    decided operation to the Directory."""

    def __init__(self, directory: Directory, algorithm: str = "otr",
                 p_drop: float = 0.0, max_phases: int = 16, device=None):
        self.directory = directory
        self.algorithm = algorithm
        self.p_drop = p_drop
        self.max_phases = max_phases
        self.device = resolve_device(device)
        self._instance = 0
        self._key = (0, 23)
        self.view_nbr = 0

    def _pool(self, n: int) -> InstancePool:
        return InstancePool(
            select(self.algorithm), n,
            scenarios.omission(n, self.p_drop, device=self.device),
            max_phases=self.max_phases, window=1, device=self.device,
        )

    def propose(self, kind: int, arg: int) -> Optional[Tuple[int, int]]:
        """Run one consensus instance on the op over the CURRENT view; on
        decision, mutate the directory (add/remove + rename) and bump the
        view.  Returns the decided (kind, arg) or None."""
        n = self.directory.group.size
        op = encode(kind, arg)
        pool = self._pool(n)
        # every current member proposes the op (clients would race here;
        # consensus picks one — DynamicMembership.scala:217-229)
        io = consensus_io(np.full((n,), op, dtype=np.int32))
        self._instance += 1
        pool.submit(self._instance, io)
        res = pool.run_pending(instance_key(self._key, self._instance))[0]
        if res.value is None:
            return None
        kind_d, arg_d = decode(int(res.value))
        self._apply(kind_d, arg_d)
        return kind_d, arg_d

    def _apply(self, kind: int, arg: int) -> None:
        if kind == ADD:
            self.directory.add_replica(f"host{arg}", arg)
        elif kind == REMOVE:
            self.directory.remove_replica(arg)  # renames ids to 0..n-1
        self.view_nbr += 1
