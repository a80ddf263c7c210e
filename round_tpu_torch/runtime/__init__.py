"""Runtime services around the engine: instances, membership, SMR, recovery.

The reference's runtime (psync.runtime) multiplexes many concurrent protocol
instances over sockets — InstanceDispatcher routes packets by the 16-bit
instance id in the Tag, Algorithm pools InstanceHandlers, and the batching
example builds state-machine replication with decision logs and recovery on
top.  Here the same services are tensor-shaped:

  - many concurrent instances  = a batch axis (instances.py InstancePool)
  - the dispatcher             = host-side slot table keyed by instance id
  - membership (Group/Directory) = host-side replica table + per-instance
    group size (membership.py), updated between instances like the
    reference's consensus-on-membership example
  - SMR / batching             = ReplicatedStateMachine over a consensus
    algorithm with a device decision log + replay/recovery (smr.py)
  - live reconfiguration       = versioned View + ViewManager: membership
    ops decided by consensus over the real wire and applied to the
    RUNNING peer table with epoch-stamped traffic (view.py)
  - the wire codec             = typed binary payload serialization with
    a restricted-pickle fallback (codec.py; the Kryo registered-class
    role) feeding the coalesced zero-copy hot path of transport.py

Port of round_tpu/runtime/__init__.py, with the same exports.  The port
has the in-process modules (instances, membership, decisions, config,
health, oob, capacity, checkpoint, smr, view, log, stats), the wire
(codec, transport) and the host runner (host, control, chaos); the lanes
and the fleet (lanes, fleet) are not ported yet.
"""

from round_tpu_torch.runtime.checkpoint import restore as restore_checkpoint
from round_tpu_torch.runtime.checkpoint import save as save_checkpoint
from round_tpu_torch.runtime.config import Options, parse_args
from round_tpu_torch.runtime.decisions import DecisionLog
from round_tpu_torch.runtime.instances import InstancePool, InstanceResult
from round_tpu_torch.runtime.membership import Directory, Group, Replica
from round_tpu_torch.runtime.smr import ReplicatedStateMachine
from round_tpu_torch.runtime.stats import Stats, stats
from round_tpu_torch.runtime.view import View, ViewManager

__all__ = [
    "InstancePool",
    "InstanceResult",
    "Directory",
    "Group",
    "Replica",
    "View",
    "ViewManager",
    "ReplicatedStateMachine",
    "Options",
    "parse_args",
    "DecisionLog",
    "Stats",
    "stats",
    "save_checkpoint",
    "restore_checkpoint",
]
