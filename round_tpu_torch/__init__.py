"""round_tpu_torch — the PyTorch/CUDA port of round_tpu.

The same framework for round-based distributed algorithms in the Heard-Of
model, written in PyTorch with the TPU kernels of the flagship path and the
config ladder re-written by hand in CUDA C++ for Hopper (``csrc/``):

  - one simulated process  = one lane of a ``torch.func.vmap``
  - one round              = send -> masked exchange -> update
  - one fault scenario     = one batch row
  - the flagship run       = ``engine.fast.run_otr_loop``, one CUDA kernel
                             launch for the whole run (``ops.fused.otr_loop``)
  - the config ladder      = ``apps.ladder``: OTR, FloodMin, LastVoting and
                             Ben-Or, each spec-checked (``spec``)
  - link drops             = ``mode="hw"`` (the default): a Philox4x32-10
                             stream in place of the TPU's hardware PRNG;
                             ``mode="hash"``: bit-exact with round_tpu
  - the device bisect tool = ``tools.bisect`` (the port of
                             tools/tpu_bisect.py, with its two probes)
  - several devices        = ``parallel.mesh``: a (scenario × proc) mesh
                             of devices held by one process, in which a
                             device may repeat; ``parallel.ici``: the
                             hand-written all-gather of its exchange

Layout mirrors round_tpu (core/, ops/, engine/, models/, spec/, apps/,
utils/, and tools/ for the repo's tools/) so every module has a
counterpart of the same name.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on CPU tensors each kernel
wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"

from round_tpu_torch.core.time import Time
from round_tpu_torch.core.progress import Progress
from round_tpu_torch.core.rounds import (
    Round, RoundCtx, SendSpec, broadcast, unicast, silence,
)
from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.ops.mailbox import Mailbox

__all__ = [
    "Time",
    "Progress",
    "Round",
    "RoundCtx",
    "SendSpec",
    "broadcast",
    "unicast",
    "silence",
    "Algorithm",
    "Mailbox",
]
