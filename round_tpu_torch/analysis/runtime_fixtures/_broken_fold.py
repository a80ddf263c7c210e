"""fold-determinism fixture: the pre-fix seq-LWW fold, verbatim bug
shape — equal-seq ties resolved by arrival order (``>=``) instead of a
deterministic tie-break, so replicas applying the same decided records
in different completion orders diverge.  (The shipped fold in
kv/store.py breaks equal-seq ties on value digest; this is what it
looked like before that fix.)"""


def lww_apply(state, rec):
    """state: {key: (seq, value)}; rec: (seq, value) for key 'k'."""
    seq, val = rec
    cur = state.get("k")
    if cur is None or seq >= cur[0]:  # lint: fold-determinism/non-commutative
        out = dict(state)
        out["k"] = (seq, val)
        return out
    return state
