from round_tpu_torch.core.time import Time, Instance
from round_tpu_torch.core.progress import Progress
from round_tpu_torch.core.rounds import (
    Round, RoundCtx, SendSpec, broadcast, unicast, silence,
)
from round_tpu_torch.core.algorithm import Algorithm

__all__ = [
    "Time",
    "Instance",
    "Progress",
    "Round",
    "RoundCtx",
    "SendSpec",
    "broadcast",
    "unicast",
    "silence",
    "Algorithm",
]
