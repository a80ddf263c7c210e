"""The frozen link counts: the whole-run kernel's and the per-round
engine's outputs for one tiny seeded batch give the same count, and that
count is the one the reference's own Heard-Of masks give."""

import torch

from hobench import mixgen, roofline
from hobench.reference import heardof, otr as ref_otr
from round_tpu_torch.engine import fast
from round_tpu_torch.models.otr import OtrState

torch.set_num_threads(1)

FAMILIES = [{"p8": 64}, {"crash_fraction": 0.25, "p8": 16},
            {"sides": 2, "heal_round": 3}, {"rotate_period": 1, "p8": 16}]
CFG = {"n": 12, "num_values": 4, "after_decision": 2, "rounds": 8,
       "link_mode": "hw"}


def _batch():
    gen = mixgen.generator(2**33 + 5, "cpu")
    S, n = 8, CFG["n"]
    structure = mixgen.draw_structure(gen, FAMILIES, S, n, "cpu")
    draws = mixgen.draw_batch(gen, S, n, {"values": 4}, "cpu")
    return structure, draws


def _state0(init):
    return OtrState(x=init, decided=torch.zeros(init.shape, dtype=torch.bool),
                    decision=torch.full_like(init, -1),
                    after=torch.full_like(init, 2))


def test_loop_and_per_round_outputs_give_one_count():
    structure, draws = _batch()
    mix = fast.FaultMix(**structure, salt0=draws["salt0"],
                        salt1=draws["salt1"])
    rnd = fast.OtrHist(n_values=4, after_decision=2)
    _, _, d_loop = fast.run_otr_loop(rnd, _state0(draws["init"]), mix, 8)
    _, _, d_hist = fast.run_hist(rnd, _state0(draws["init"]),
                                 lambda s: s.decided, mix, 8)
    assert (d_loop >= 0).any()
    a = roofline.loop_links(structure, d_loop, 8, 1)
    b = roofline.loop_links(structure, d_hist, 8, 1)
    assert a == b and sum(a) > 0


def test_loop_count_is_the_references_drawn_links():
    structure, draws = _batch()
    rows = dict(structure, salt0=draws["salt0"], salt1=draws["salt1"])
    out = ref_otr.run(rows, draws["init"], CFG)
    counted = roofline.loop_links(structure, out["decided_round"], 8, 1)
    n = CFG["n"]
    hashed = ((structure["p8"] > 0) & (structure["p8"] < 256))[:, None, None]
    for r in range(8):
        last = torch.where(out["decided_round"] >= 0,
                           out["decided_round"] + 1, 8)
        active = r <= last
        # every link i -> j, i != j, between an active receiver and a
        # sender the fault structure lets speak
        sends = active & mixgen.round_colmask(structure, r)
        pairs = active[:, :, None] & sends[:, None, :]
        pairs &= ~torch.eye(n, dtype=torch.bool)[None] & hashed
        assert counted[r] == float(pairs.sum())
    # and the mask the reference draws keeps no link outside those pairs
    heard = heardof.delivered(rows, 0, torch.ones(8, n, dtype=torch.bool),
                              "hw")
    assert heard.any()


def test_exchange_count_covers_every_receiver():
    structure, draws = _batch()
    d = torch.full((8, CFG["n"]), -1, dtype=torch.int32)
    assert roofline.exchange_links(structure, d, 2, 1)[0] >= \
        roofline.loop_links(structure, d, 2, 1)[0]


def test_bound_takes_the_larger_time():
    ops = roofline.HW_OPS
    assert roofline.bound_ms(3.35e9, 0, ops) == 1.0
    per_pipe = max(ops[0], ops[1], sum(ops) / 2)
    links = roofline.INT_OPS_PER_S / per_pipe
    assert abs(roofline.bound_ms(0, links, ops) - 1e3) < 1e-6
