"""The port's verifier against round_tpu's on OTR's suite of
tests/test_verifier.py (the hand-translated OtrExample VCs, the staged
progress chain and its negative controls).

The tests are round_tpu's, run over the port by the harness of
tests/test_torch_verifier.py; each says in its docstring whether its
verdicts are computed by both packages (``[both]``) or held to the ones
round_tpu's test asserts (``[asserted]``).
"""

from __future__ import annotations

import torch

from test_torch_verifier import OTR_ASSERTED, install_twins

torch.set_num_threads(1)

install_twins(globals(), "test_verifier", OTR_ASSERTED,
              only=lambda name: name.startswith("test_otr"))
