"""Membership: Replica / Group / Directory (reference: runtime/Replicas.scala).

Port of round_tpu/runtime/membership.py, unchanged (pure Python).

The reference keeps an immutable ``Group`` (pid -> network address) wrapped in
a lock-guarded ``Directory`` that supports add/remove/compact for dynamic
membership; TCP channels are rewired when the group changes
(TcpRuntime.scala:75-110) and ids are renamed to stay contiguous
(``renameReplica``, Replicas.scala:136-142).

Here the group is host-side metadata: an instance always executes over lanes
0..n-1 of the engine, and the Group maps those lane ids to stable replica
names/addresses.  Membership changes happen *between* instances (exactly the
reference's DynamicMembership pattern: consensus decides a membership op,
then the group is updated and the next instance runs over the new group) —
so a change is: mutate the Directory, then start new instances with the new
``group.size``.  Addresses are opaque to the simulator (the wire there is
the on-device exchange kernel); the host deployment path consumes them —
runtime/host.py + runtime/transport.py run one replica per OS process with
the id→(host, port) map as the peer table (the reference's Replica records,
Replicas.scala:9-18).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Replica:
    """One group member: stable id + address (Replicas.scala:9-18)."""

    id: int
    address: str = ""
    port: int = 0

    def rename(self, new_id: int) -> "Replica":
        return Replica(new_id, self.address, self.port)


class Group:
    """Immutable membership indexed by contiguous ProcessID 0..n-1
    (Replicas.scala:20-131)."""

    def __init__(self, replicas: Sequence[Replica], check_contiguous: bool = True):
        self.replicas: Tuple[Replica, ...] = tuple(replicas)
        if check_contiguous:
            ids = [r.id for r in self.replicas]
            if ids != list(range(len(ids))):
                raise ValueError(f"replica ids must be 0..n-1, got {ids}")
        self._by_addr: Dict[Tuple[str, int], Replica] = {
            (r.address, r.port): r for r in self.replicas
        }

    @property
    def size(self) -> int:
        return len(self.replicas)

    def get(self, pid: int) -> Replica:
        return self.replicas[pid]

    def contains(self, pid: int) -> bool:
        return 0 <= pid < len(self.replicas)

    def inet_to_id(self, address: str, port: int) -> Optional[int]:
        """Address -> pid (Replicas.scala:74-80)."""
        r = self._by_addr.get((address, port))
        return r.id if r is not None else None

    def add(self, address: str, port: int = 0) -> "Group":
        """New group with one more replica at the next id."""
        return Group(self.replicas + (Replica(self.size, address, port),))

    def remove(self, pid: int) -> "Group":
        """New group without ``pid``, remaining ids renamed to 0..n-2
        (the compaction of renameReplica, Replicas.scala:136-142)."""
        if not self.contains(pid):
            raise KeyError(pid)
        kept = [r for r in self.replicas if r.id != pid]
        return Group([r.rename(i) for i, r in enumerate(kept)])

    def renaming_from(self, old: "Group") -> Dict[int, Optional[int]]:
        """Map each old pid to its new pid (None if removed) — what a
        decision log migration needs after a membership change."""
        out: Dict[int, Optional[int]] = {}
        for r in old.replicas:
            out[r.id] = self.inet_to_id(r.address, r.port)
        return out


class Directory:
    """Lock-guarded mutable view of the current Group
    (Replicas.scala:152-201)."""

    def __init__(self, group: Group):
        self._group = group
        self._lock = threading.Lock()

    @property
    def group(self) -> Group:
        with self._lock:
            return self._group

    @group.setter
    def group(self, g: Group) -> None:
        with self._lock:
            self._group = g

    @property
    def size(self) -> int:
        return self.group.size

    def add_replica(self, address: str, port: int = 0) -> Group:
        with self._lock:
            self._group = self._group.add(address, port)
            return self._group

    def remove_replica(self, pid: int) -> Group:
        with self._lock:
            self._group = self._group.remove(pid)
            return self._group


def local_group(n: int, base_port: int = 4444) -> Group:
    """A localhost group of n replicas (the shape of sample-conf.xml)."""
    return Group([Replica(i, "127.0.0.1", base_port + i) for i in range(n)])
