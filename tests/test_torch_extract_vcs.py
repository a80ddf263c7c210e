"""The extracted-stage VCs and lemmas of the port: round_tpu's
tests/test_extract_vcs.py, test_lv_extract.py and test_event_extract.py
run over the port by the harness of tests/test_torch_verifier.py (the
builders trace the port's torch round code on the CPU; what round_tpu
marks ``slow`` stays ``slow``).  Every top-level verdict is computed by
both packages (``[both]``): the port's on the formulas it extracted, and
round_tpu's on the same formulas carried into its classes.
"""

from __future__ import annotations

import torch

from test_torch_verifier import install_twins

torch.set_num_threads(1)

install_twins(globals(), "test_extract_vcs", {})
install_twins(globals(), "test_lv_extract", {})
install_twins(globals(), "test_event_extract", {})
