"""Transition-relation extraction from the port's torch round code
(round_tpu_torch/verify/extract.py, auxmethod.py and the nine extracted
builders of protocols.py) against round_tpu's jaxpr extraction.

  * The nine builders trace the port's own ``ops/mailbox.py`` and models
    on the CPU; everything they return prints as round_tpu's builder
    does, once the fresh names of both are renamed canonically in the
    order they first occur (``verify.extract.canon``: the
    extractor's ``ext!`` counter ticks per graph node, and an aten graph
    visits other nodes than a jaxpr).
  * The extracted-stage VCs and lemmas are in
    tests/test_torch_extract_vcs.py.
  * round_tpu's tests/test_extract.py and test_auxmethod.py, rewritten
    over torch: the differential test against execution, the
    ExtractionError cases, and the seven @aux_method cases.
  * What is the port's own: host reads, unsupported aten ops, unread sort
    indices and the reserved aux namespace raise; the extractor's default
    device is the card.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from test_torch_verifier import built_alike, dump, dumps_equal
from round_tpu_torch.verify.auxmethod import aux_method
from round_tpu_torch.verify.cl import ClConfig, entailment
from round_tpu_torch.verify.extract import (
    ExtractionError, Scalar, Vec, extract_lane_fn,
)
from round_tpu_torch.verify.formula import (
    AND, Application, Binding, Bool, CARD, COMPREHENSION, EQ, EXISTS, FORALL,
    FunT, GEQ, GT, IMPLIES, IN, ITE, Int, IntLit, LEQ, LT, Literal, MINUS,
    NEQ, NOT, OR, PLUS, TIMES, UMINUS, UnInterpretedFct, Variable, And, Eq,
    Geq, Gt, Or, procType,
)
from round_tpu_torch.verify.tr import StateSig, ho_of

torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# The nine builders print as round_tpu's
# ---------------------------------------------------------------------------

BUILDERS = [
    ("otr_extracted_tr", ()), ("lv_extracted_tr", ()),
    ("epsilon_extracted_tr", ()), ("tpce_extracted_tr", ()),
    ("lve_extracted_tr", ()), ("floodmin_extracted_tr", ()),
    ("kset_extracted_tr", ()), ("benor_extracted_tr", ()),
    ("benor_extracted_tr", ("bok",)), ("pbft_vc_selection_extracted", ()),
]


@pytest.mark.parametrize("name,args", BUILDERS,
                         ids=[f"{n}{'-' + a[0] if a else ''}"
                              for n, a in BUILDERS])
def test_builder_prints_as_round_tpu(name, args):
    import round_tpu.verify.protocols as rp
    import round_tpu_torch.verify.protocols as pp

    rt, pt = built_alike(lambda: getattr(rp, name)(*args),
                         lambda: getattr(pp, name)(*args, device="cpu"))
    assert "ext!" in dump(rt)
    dumps_equal(rt, pt)


# ---------------------------------------------------------------------------
# round_tpu's tests/test_extract.py over torch
# ---------------------------------------------------------------------------

def evaluate(f, env):
    """Evaluate a Formula over a concrete model (round_tpu's
    tests/test_extract.py::evaluate).  env maps variable names to values,
    function names to callables and '__universe__' to the process ids."""
    if isinstance(f, Literal):
        return f.value
    if isinstance(f, Variable):
        return env[f.name]
    if isinstance(f, Binding):
        universe = env["__universe__"]
        assert len(f.vars) == 1
        var = f.vars[0]

        def with_v(val):
            sub = dict(env)
            sub[var.name] = val
            return sub

        if f.binder == COMPREHENSION:
            return [p for p in universe if evaluate(f.body, with_v(p))]
        if f.binder == FORALL:
            return all(evaluate(f.body, with_v(p)) for p in universe)
        return any(evaluate(f.body, with_v(p)) for p in universe)
    a = [evaluate(x, env) for x in f.args]
    ops = {
        AND: lambda: all(a), OR: lambda: any(a), NOT: lambda: not a[0],
        IMPLIES: lambda: (not a[0]) or a[1], EQ: lambda: a[0] == a[1],
        NEQ: lambda: a[0] != a[1], PLUS: lambda: sum(a),
        MINUS: lambda: a[0] - a[1], UMINUS: lambda: -a[0],
        TIMES: lambda: int(np.prod(a)), LT: lambda: a[0] < a[1],
        LEQ: lambda: a[0] <= a[1], GT: lambda: a[0] > a[1],
        GEQ: lambda: a[0] >= a[1], ITE: lambda: a[1] if a[0] else a[2],
        CARD: lambda: len(a[0]), IN: lambda: a[0] in a[1],
    }
    if f.fct in ops:
        return ops[f.fct]()
    return env[f.fct.name](*a)


N_EX = 5  # example shape for tracing


def _voting_update(x, decided, vals, mask):
    """A per-lane quorum-voting update in plain torch: count the senders
    that agree with my estimate; with more than 2·7/3 of them, decide."""
    votes = (mask & (vals == x)).to(torch.int32).sum()
    quorum = votes * 3 > 2 * 7
    return x, decided | quorum


def _extract_voting():
    sig = StateSig({"x": Int, "decided": Bool})
    j = Variable("j", procType)
    snd = UnInterpretedFct("sndx", FunT([procType], Int))

    def senders(i):
        return Application(IN, [i, ho_of(j)]).with_type(Bool)

    ex_args = [torch.tensor(0, dtype=torch.int32), torch.tensor(False),
               torch.zeros(N_EX, dtype=torch.int32),
               torch.zeros(N_EX, dtype=torch.bool)]
    fargs = [
        Scalar(sig.get("x", j)),
        Scalar(sig.get("decided", j)),
        Vec(lambda i: Application(snd, [i]).with_type(Int)),
        Vec(lambda i: Literal(True)),
    ]
    outs = extract_lane_fn(_voting_update, ex_args, fargs, senders,
                           device="cpu")
    return sig, j, snd, outs


def test_extract_shapes():
    sig, j, snd, outs = _extract_voting()
    assert len(outs) == 2
    x_out, dec_out = outs
    assert isinstance(x_out, Scalar) and isinstance(dec_out, Scalar)
    assert repr(x_out.f) == "x(j)"
    s = repr(dec_out.f)
    assert "Cardinality" in s and "HO(j)" in s and "sndx" in s


def test_extract_differential_vs_execution():
    """The extracted formula and the executed torch function agree on
    every (HO set, values, estimate) over a small concrete universe."""
    sig, j, snd, outs = _extract_voting()
    dec_formula = outs[1].f
    universe = list(range(N_EX))
    rng = np.random.default_rng(0)
    for _ in range(200):
        ho = rng.random(N_EX) < 0.6
        vals = rng.integers(0, 3, N_EX)
        x = int(rng.integers(0, 3))
        decided = bool(rng.integers(0, 2))
        _, dec_exec = _voting_update(
            torch.tensor(x, dtype=torch.int32), torch.tensor(decided),
            torch.as_tensor(vals, dtype=torch.int32), torch.as_tensor(ho),
        )
        env = {
            "__universe__": universe,
            "j": 0,
            "x": lambda p, x=x: x,
            "decided": lambda p, d=decided: d,
            "sndx": lambda p, v=vals: int(v[p]),
            "HO": lambda p, h=ho: [q for q in universe if h[q]],
        }
        assert evaluate(dec_formula, env) == bool(dec_exec), (
            ho, vals, x, decided)


def _senders_j():
    j = Variable("j", procType)
    return lambda i: Application(IN, [i, ho_of(j)]).with_type(Bool)


def test_extract_any_all():
    def upd(flag, vals, mask):
        return (mask & (vals > 0)).any(), (vals >= 0).all()

    snd = UnInterpretedFct("s", FunT([procType], Int))
    outs = extract_lane_fn(
        upd,
        [torch.tensor(False), torch.zeros(N_EX, dtype=torch.int32),
         torch.zeros(N_EX, dtype=torch.bool)],
        [Scalar(Literal(False)),
         Vec(lambda i: Application(snd, [i]).with_type(Int)),
         Vec(lambda i: Literal(True))],
        _senders_j(), device="cpu",
    )
    assert isinstance(outs[0].f, Binding) and outs[0].f.binder == EXISTS
    assert isinstance(outs[1].f, Binding) and outs[1].f.binder == FORALL


def test_extract_select_n():
    outs = extract_lane_fn(
        lambda c, a, b: torch.where(c, a, b),
        [torch.tensor(True), torch.tensor(1, dtype=torch.int32),
         torch.tensor(2, dtype=torch.int32)],
        [Scalar(Variable("c", Bool)), Scalar(Variable("a", Int)),
         Scalar(Variable("b", Int))],
        lambda i: Literal(True), device="cpu",
    )
    assert repr(outs[0].f) == "Ite(c, a, b)"


def test_extract_unsupported_op_message():
    """An op outside the fragment raises an ExtractionError that names
    the aten op and points at the auxiliary-function mechanism."""
    with pytest.raises(ExtractionError) as e:
        extract_lane_fn(
            lambda vals: torch.sin(vals)[0] > 0,
            [torch.zeros(N_EX, dtype=torch.float32)],
            [Vec(lambda i: Variable("v", Int))],
            lambda i: Literal(True), device="cpu",
        )
    assert "aten::sin" in str(e.value) and "aux" in str(e.value)


def test_extract_sort_now_supported():
    """A plain sort of mailbox values extracts to the rank function with
    its order-statistics axioms (no @aux_method contract needed)."""
    outs, axioms = extract_lane_fn(
        lambda vals: torch.sort(vals).values[0],
        [torch.zeros(N_EX, dtype=torch.int32)],
        [Vec(lambda i: Variable("v", Int))],
        lambda i: Literal(True), return_axioms=True, device="cpu",
    )
    assert "ext!sort!" in repr(outs[0].f)
    assert len(axioms) == 4  # S1, S2, S3a, S3b (no pad => no dominance)


def test_extract_true_sum_rejected():
    """Summing payload values (not an indicator) raises, not a silently
    wrong Cardinality."""
    snd = UnInterpretedFct("s2", FunT([procType], Int))
    with pytest.raises(ExtractionError) as e:
        extract_lane_fn(
            lambda vals: vals.sum(),
            [torch.zeros(N_EX, dtype=torch.int32)],
            [Vec(lambda i: Application(snd, [i]).with_type(Int))],
            lambda i: Literal(True), device="cpu",
        )
    assert "non-indicator" in str(e.value)


# ---------------------------------------------------------------------------
# The port's own refusals and device rule
# ---------------------------------------------------------------------------

def test_host_read_is_refused():
    """A host read of a traced tensor would specialise the trace to the
    example's value (n = 5 baked in); it raises instead."""
    def upd(n, mask):
        return mask.to(torch.int32).sum() > int(n) // 2

    with pytest.raises(ExtractionError, match="host"):
        extract_lane_fn(
            upd, [torch.tensor(5, dtype=torch.int32),
                  torch.zeros(N_EX, dtype=torch.bool)],
            [Scalar(Variable("n", Int)), Vec(lambda i: Literal(True))],
            lambda i: Literal(True), device="cpu",
        )


def test_n_stays_symbolic():
    """``n`` passed as a 0-d tensor stays the symbol: (2·n) div 3 with the
    constant factor first, as the round code writes it."""
    outs = extract_lane_fn(
        lambda n, mask: mask.to(torch.int32).sum() > (2 * n) // 3,
        [torch.tensor(5, dtype=torch.int32),
         torch.zeros(N_EX, dtype=torch.bool)],
        [Scalar(Variable("n", Int)), Vec(lambda i: Literal(True))],
        lambda i: Literal(True), device="cpu",
    )
    assert "Divides(Times(2, n), 3)" in repr(outs[0].f)


def test_sort_indices_read_is_refused():
    with pytest.raises(ExtractionError, match="sort indices"):
        extract_lane_fn(
            lambda vals: torch.sort(vals).indices[0] > 0,
            [torch.zeros(N_EX, dtype=torch.int32)],
            [Vec(lambda i: Variable("v", Int))],
            lambda i: Literal(True), device="cpu",
        )


def test_unregistered_aux_namespace_op_is_refused():
    """An operator in the reserved aux namespace that no @aux_method
    registered is refused, not interpreted."""
    op = torch.library.custom_op(
        "rtaux::unregistered_t", lambda a: a.clone(), mutates_args=(),
        schema="(Tensor a) -> Tensor")
    op.register_fake(lambda a: a.clone())
    with pytest.raises(ExtractionError, match="reserved aux namespace"):
        extract_lane_fn(
            lambda a: op(a), [torch.tensor(0, dtype=torch.int32)],
            [Scalar(Variable("a", Int))], lambda i: Literal(True),
            device="cpu",
        )


def test_default_device_is_the_card():
    """With no ``device=``, the trace runs on the CUDA device, and raises
    where there is none."""
    fargs = [Scalar(Variable("a", Int))]
    ex = [torch.tensor(0, dtype=torch.int32)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            extract_lane_fn(lambda a: a + 1, ex, fargs,
                            lambda i: Literal(True))
    else:
        outs = extract_lane_fn(lambda a: a + 1, ex, fargs,
                               lambda i: Literal(True))
        assert repr(outs[0].f) == "Plus(a, 1)"


def test_first_true_extraction_form_is_the_same_index():
    """ops.mailbox.first_true has one body, torch.argmax of the 0/1 mask,
    which the engine runs and the extractor reads as the boolean argmax
    site: it is the first index where the mask holds (0 where none), on
    every row, inside an extraction trace and outside it."""
    from round_tpu_torch.ops import detsum
    from round_tpu_torch.ops.mailbox import first_true

    rng = np.random.default_rng(1)
    for n in (1, 2, 5, 33):
        for _ in range(50):
            m = rng.random((3, n)) < rng.random()
            want = [int(np.flatnonzero(row)[0]) if row.any() else 0
                    for row in m]
            got = first_true(torch.as_tensor(m))
            with detsum.extracting():
                traced_form = first_true(torch.as_tensor(m))
            assert got.tolist() == want
            assert torch.equal(got, traced_form)


# ---------------------------------------------------------------------------
# round_tpu's tests/test_auxmethod.py over torch
# ---------------------------------------------------------------------------

@aux_method(
    pre=lambda a, b: And(Geq(a, IntLit(0)), Geq(b, IntLit(0))),
    post=lambda r, a, b: And(Geq(r, a), Geq(r, b), Or(Eq(r, a), Eq(r, b))),
    name="imax_t",
)
def imax(a, b):
    return torch.maximum(a, b)


def _extract():
    def upd(x, y):
        return imax(x, y) + 1

    xv = Variable("xv", Int)
    yv = Variable("yv", Int)
    outs, axioms, obligations = extract_lane_fn(
        upd, [torch.tensor(0, dtype=torch.int32),
              torch.tensor(0, dtype=torch.int32)],
        [Scalar(xv), Scalar(yv)],
        lambda i: Literal(True), return_axioms=True,
        return_obligations=True, device="cpu",
    )
    return xv, yv, outs, axioms, obligations


def test_aux_executes_normally():
    assert int(imax(torch.tensor(3), torch.tensor(7))) == 7


def test_aux_extraction_shape():
    xv, yv, outs, axioms, obligations = _extract()
    out = outs[0].f
    # x' = aux!imax_t(xv, yv) + 1
    assert "aux!imax_t" in repr(out)
    assert len(axioms) == 1 and len(obligations) == 1
    assert "Geq" in repr(axioms[0])
    assert repr(obligations[0]) == repr(
        And(Geq(xv, IntLit(0)), Geq(yv, IntLit(0)))
    )


def test_aux_post_supports_proof():
    """The assumed post makes  x' > x ∧ x' > y  provable from the
    extracted equation (the call-site inlining of posts,
    TransitionRelation.scala:93-111)."""
    xv, yv, outs, axioms, _obl = _extract()
    xp = Variable("xp", Int)
    hyp = And(Eq(xp, outs[0].f), *axioms)
    cfg = ClConfig(venn_bound=0, inst_depth=1)
    assert entailment(hyp, And(Gt(xp, xv), Gt(xp, yv)), cfg, timeout_s=30)


def test_aux_without_post_is_opaque():
    """Negative control: without the post axioms the same claim fails —
    the helper really is uninterpreted."""
    xv, yv, outs, _axioms, _obl = _extract()
    xp = Variable("xp", Int)
    cfg = ClConfig(venn_bound=0, inst_depth=1)
    assert not entailment(Eq(xp, outs[0].f), Gt(xp, xv), cfg, timeout_s=30)


def test_aux_duplicate_name_rejected():
    with pytest.raises(ValueError):
        @aux_method(name="imax_t")
        def other(a):
            return a


def test_aux_obligations_cannot_be_dropped():
    """extract_lane_fn refuses to discard recorded pre-conditions."""
    with pytest.raises(ExtractionError, match="pre-conditions"):
        extract_lane_fn(
            lambda x, y: imax(x, y),
            [torch.tensor(0, dtype=torch.int32),
             torch.tensor(0, dtype=torch.int32)],
            [Scalar(Variable("a", Int)), Scalar(Variable("b", Int))],
            lambda i: Literal(True), return_axioms=True, device="cpu",
        )


def test_aux_reregistration_contract_change_warns():
    """Same-qualname re-registration with a CHANGED pre/post (a module
    reload with an edited contract) warns — earlier extractions baked in
    the old contract."""
    from round_tpu_torch.verify import auxmethod

    def helper(a):
        return a

    try:
        deco = aux_method(post=lambda r, a: Geq(r, a), name="rereg_t")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            deco(helper)                 # first registration: silent
            aux_method(post=lambda r, a: Geq(r, a), name="rereg_t")(helper)
        with pytest.warns(UserWarning, match="different pre/post"):
            aux_method(post=lambda r, a: Gt(r, a), name="rereg_t")(helper)

        def mk(bound):
            return lambda r, a: Geq(r, IntLit(bound))

        with pytest.warns(UserWarning, match="different pre/post"):
            aux_method(post=mk(5), name="rereg_t")(helper)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            aux_method(post=mk(5), name="rereg_t")(helper)
        with pytest.warns(UserWarning, match="different pre/post"):
            aux_method(post=mk(6), name="rereg_t")(helper)
    finally:
        auxmethod.REGISTRY.pop("rereg_t", None)
