"""A replicated lock service: acquire/release decided through consensus.

Reference parity: example/LockManager.scala (348 LoC): replicas run
consensus on lock operations from external clients; a client's
acquire/release either succeeds (it becomes/stops being the holder) or
fails if the lock state disagrees.  The critical property — all replicas
agree on the holder at every point — follows from consensus on the
operation order.

Commands are int-encoded: op*2^16 + client  (op: 1=acquire, 2=release).
The replicated state machine is  holder: int  (-1 = free).

Port of round_tpu/apps/lock_manager.py.  The state machine runs on
``device`` (the card unless the caller passes another); a batch folds as
a Python loop over its commands where round_tpu scans.  Consensus keys
follow the port's rule (runtime/instances.py::instance_key on round_tpu's
``PRNGKey(7)``, the pair (0, 7)), so with the default lossless sampler
the decisions are round_tpu's.  The service decodes client requests with
the wire deserializer (runtime/codec.py::loads: codec frames, else the
restricted unpickler) where round_tpu calls ``pickle.loads`` on socket
bytes; an honest client's ``pickle.dumps((op, client))`` decodes the
same, and a garbage request is dropped.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from round_tpu_torch.apps.selector import select
from round_tpu_torch.engine import scenarios
from round_tpu_torch.runtime.instances import instance_key
from round_tpu_torch.runtime.smr import ReplicatedStateMachine
from round_tpu_torch.utils.device import resolve_device

ACQUIRE, RELEASE = 1, 2
FREE = -1


def encode(op: int, client: int) -> int:
    return op * (1 << 16) + client


def decode(cmd: int) -> Tuple[int, int]:
    return cmd // (1 << 16), cmd % (1 << 16)


def _apply(holder, cmd_batch):
    """Fold one decided command batch into the holder state (pure, on the
    batch's device; round_tpu scans the same step)."""
    for cmd in cmd_batch:
        op = cmd // (1 << 16)
        client = cmd % (1 << 16)
        acquire_ok = (op == ACQUIRE) & (holder == FREE)
        release_ok = (op == RELEASE) & (holder == client)
        holder = torch.where(acquire_ok, client, holder)
        holder = torch.where(release_ok, FREE, holder)
    return holder


class LockManager:
    """One replica of the lock service."""

    def __init__(self, n: int = 4, algorithm: str = "lv", p_drop: float = 0.0,
                 batch_size: int = 4, device=None):
        device = resolve_device(device)
        self.smr = ReplicatedStateMachine(
            algo=select(algorithm),
            n=n,
            apply_fn=_apply,
            sm_init=torch.tensor(FREE, dtype=torch.int32),
            batch_size=batch_size,
            ho_sampler=scenarios.omission(n, p_drop, device=device),
            device=device,
        )
        self._key = (0, 7)  # round_tpu's PRNGKey(7)
        self._step = 0

    # -- client surface (LockManager's external TCP clients) ---------------

    def request(self, op: int, client: int) -> None:
        self.smr.propose([encode(op, client)])

    def acquire(self, client: int) -> None:
        self.request(ACQUIRE, client)

    def release(self, client: int) -> None:
        self.request(RELEASE, client)

    def process(self) -> int:
        """Run consensus on queued requests; returns #instances decided."""
        self._step += 1
        return self.smr.run(
            instance_key(self._key, self._step), pad_with_noop=True
        )

    def holder(self) -> int:
        """The current lock holder (applies decided batches first)."""
        return int(self.smr.apply_decided())


# ---------------------------------------------------------------------------
# External TCP client service (LockManager.scala + README.md:183-199: the
# lock service replicas accept out-of-group clients over the wire)
# ---------------------------------------------------------------------------

# user-definable Tag flags (>= 3, Tag.scala:5-12) for the client protocol
FLAG_LOCK_REQ = 8    # payload: (op, client_id); op in {ACQUIRE, RELEASE}
FLAG_LOCK_REPLY = 9  # payload: (ok, holder)


def serve(lm: LockManager, transport, rounds: Optional[int] = None) -> int:
    """Run the service loop on `transport` (runtime/transport.py
    HostTransport): each FLAG_LOCK_REQ message is proposed to the replicated
    state machine, consensus runs, and the client gets FLAG_LOCK_REPLY with
    (ok, holder).  `rounds` bounds the loop for tests; None = serve forever.
    Returns the number of requests served."""
    import pickle

    from round_tpu_torch.runtime import codec
    from round_tpu_torch.runtime.oob import Tag

    served = 0
    while rounds is None or served < rounds:
        got = transport.recv(200)
        if got is None:
            if transport.closed:  # transport.stop() ends the service loop
                break
            continue
        sender, tag, raw = got
        if tag.flag != FLAG_LOCK_REQ:
            continue
        try:
            op, client = codec.loads(raw)
        except Exception:  # noqa: BLE001 — a garbage request is dropped
            continue
        before = lm.holder()
        lm.request(op, client)
        lm.process()
        holder = lm.holder()
        ok = (
            (op == ACQUIRE and holder == client)
            or (op == RELEASE and before == client and holder == FREE)
        )
        transport.send(
            sender, Tag(instance=tag.instance, flag=FLAG_LOCK_REPLY),
            pickle.dumps((ok, holder)),
        )
        served += 1
    return served


def main(argv=None) -> int:
    """Serve the replicated lock over the native transport:

        python -m round_tpu_torch.apps.lock_manager --port 7500

    Clients connect with a HostTransport id outside the service id and send
    FLAG_LOCK_REQ messages (tests/test_host.py::test_lock_manager_service
    is the client recipe)."""
    import argparse

    from round_tpu_torch.runtime.transport import HostTransport

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--algorithm", type=str, default="lv")
    ap.add_argument("--rounds", type=int, default=None,
                    help="serve this many requests then exit (default: forever)")
    ap.add_argument("--device", type=str, default=None,
                    help="where the consensus runs (default: cuda)")
    args = ap.parse_args(argv)
    lm = LockManager(n=args.n, algorithm=args.algorithm, device=args.device)
    with HostTransport(0, args.port) as tr:
        print(f"lock service on port {tr.port}", flush=True)
        serve(lm, tr, rounds=args.rounds)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
