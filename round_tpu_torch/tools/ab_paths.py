"""One reading of the unchanged paths, for an A/B of two trees on one card.

    cd <tree> && python3 <this file> <label>

Imports round_tpu_torch from the current directory (a checkout of either
commit), runs the hash flagship (n=1024 x 10,000 x 50 rounds), the hash
per-round path (S=1,000) and the floodmin rung, each as ``chip_smoke.py``
calls them, and prints one JSON line of their rounds/sec.  Compare two
commits in one chip call, in turns, with each tree unpacked in its own
directory and TOOL the absolute path of this file:

    for t in parent change change parent; do (cd $t && python3 $TOOL $t); done
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys


def main(label: str) -> dict:
    # the tree in the current directory first, and not this file's own
    # directory, whose bisect.py would shadow the standard library's
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [os.getcwd()] + [p for p in sys.path
                                   if os.path.abspath(p or ".") != here]
    import torch

    from round_tpu_torch import bench
    from round_tpu_torch.apps import ladder

    # a tree from before the bench's ladder arm has no --no-ladder (and no
    # ladder to skip)
    quiet = (["--no-ladder"] if "--no-ladder" in open(bench.__file__).read()
             else [])
    common = ["--n", "1024", "--phases", "50", "--values", "16", "--p-drop",
              "0.25", "--seed", "0", "--parity", "0", "--device", "cuda",
              "--rng", "hash"] + quiet
    with contextlib.redirect_stdout(io.StringIO()):
        flag = bench.main(common + ["--scenarios", "10000", "--engine",
                                    "loop", "--repeats", "2"])
        per_round = bench.main(common + ["--scenarios", "1000", "--engine",
                                         "fused", "--repeats", "1"])
        fm = ladder.RUNGS["floodmin"](repeats=2, device=torch.device("cuda"))
    out = {"side": label, "flagship_hash": flag["value"],
           "per_round_hash": per_round["value"],
           "floodmin": fm["extra"]["rounds_per_sec"]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
