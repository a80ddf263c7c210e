"""The port's verifier against round_tpu's on LastVoting
(tests/test_lv_verify.py): the LvExample VCs, the staged inductiveness
chain and its decomposed sub-VCs.

The tests are round_tpu's, run over the port by the harness of
tests/test_torch_verifier.py (what round_tpu marks ``slow`` stays
``slow``); each says in its docstring whether its verdicts are computed
by both packages (``[both]``) or held to the ones round_tpu's test
asserts (``[asserted]``).  The LastVoting suites the tests build print
as round_tpu's, up to the canonical renaming of fresh names.
"""

from __future__ import annotations

import pytest
import torch

from test_torch_verifier import built_alike, dumps_equal, install_twins

torch.set_num_threads(1)

_HEAVY = "round_tpu's run takes over 3 s; the port's verdicts are held to " \
         "the ones it asserts"


def _heavy_sub_vcs(kw):
    """k in {1, 5, 17}"""
    return kw.get("k") in (1, 5, 17)


install_twins(globals(), "test_lv_verify", {
    "test_lv_init_implies_invariant": _HEAVY,
    "test_lv_phase_walk_proves_and_requires_liveness": _HEAVY,
    "test_lv_stage_subvcs": (_HEAVY, _heavy_sub_vcs),
    "test_lv_maxts_lemma": _HEAVY,
    "test_lv_inductive_stages_discharge": _HEAVY,
    "test_lv_verifies_end_to_end": _HEAVY,
})


@pytest.mark.parametrize("suite", ["lv_spec", "lv_staged_vcs",
                                   "lv_stage_subvcs", "lv_staged_chains"])
def test_lv_suite_prints_as_round_tpu(suite):
    import round_tpu.verify.protocols as rp
    import round_tpu_torch.verify.protocols as pp

    dumps_equal(*built_alike(getattr(rp, suite), getattr(pp, suite)))


def test_lv_verifier_spec_vcs_print_as_round_tpu():
    import round_tpu.verify.protocols as rp
    import round_tpu.verify.verifier as rv
    import round_tpu_torch.verify.protocols as pp
    import round_tpu_torch.verify.verifier as pv

    dumps_equal(*built_alike(
        lambda: rv.Verifier(rp.lv_verifier_spec()).generate_vcs(),
        lambda: pv.Verifier(pp.lv_verifier_spec()).generate_vcs()))
