"""Every cell on the card for a short window, with the check at the cell's
own sizes.  On the card:
`python -m pytest hobench/tests/test_hobench_cuda.py -q -m cuda`."""

import contextlib
import io
import json

import pytest
import torch

from hobench.tests.hobench_util import REPO, cells

torch.set_num_threads(1)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hobench import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(2**32 + 3),
                       "--seconds", "1", "--trace", "1"], root=REPO)
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is True
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
