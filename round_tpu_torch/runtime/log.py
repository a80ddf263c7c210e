"""Leveled logging for the framework (the dzufferey.utils.Logger role:
-v/-q/--hide verbosity plumbing, utils/Options.scala:8-27 + logback.xml).

Port of round_tpu/runtime/log.py, under the port's own logger root.

A thin layer over the stdlib: one `round_tpu_torch` logger hierarchy, a
`configure(verbosity)` entry the CLIs share (each -v raises, each -q
lowers, mirroring the reference's flag semantics), and `hide(prefix)` for
the reference's --hide (suppress a component's output by name).

    from round_tpu_torch.runtime.log import get_logger
    log = get_logger("engine")          # round_tpu_torch.engine
    log.info("round %d", r)
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

ROOT = "round_tpu_torch"

_LEVELS = [logging.ERROR, logging.WARNING, logging.INFO, logging.DEBUG]


class _DynamicStderr:
    """Resolve sys.stderr at EMIT time: pytest's capture machinery (and
    anything else that swaps sys.stderr) keeps working, and a handler bound
    at first-configure time can never wedge logging onto a closed stream."""

    def __init__(self, explicit=None):
        self.explicit = explicit

    def write(self, s):
        (self.explicit or sys.stderr).write(s)

    def flush(self):
        f = self.explicit or sys.stderr
        if not getattr(f, "closed", False):
            f.flush()


def get_logger(component: Optional[str] = None) -> logging.Logger:
    name = ROOT if not component else f"{ROOT}.{component}"
    return logging.getLogger(name)


def configure(verbosity: int = 0, stream=None) -> logging.Logger:
    """verbosity 0 = warnings (the reference's default Notice-ish level),
    each +1 → info/debug, each -1 → errors only.  Re-configurable: each
    call replaces the handler (so a later stream= takes effect) and the
    default destination tracks the CURRENT sys.stderr."""
    root = logging.getLogger(ROOT)
    idx = max(0, min(len(_LEVELS) - 1, verbosity + 1))
    root.setLevel(_LEVELS[idx])
    for h in list(root.handlers):
        root.removeHandler(h)
    h = logging.StreamHandler(_DynamicStderr(stream))
    h.setFormatter(logging.Formatter("[%(levelname).1s %(name)s] %(message)s"))
    root.addHandler(h)
    root.propagate = False
    return root


_hidden: set = set()


def hide(component: str) -> None:
    """Suppress one component's output (--hide, Options.scala:11-13).
    Undone by unhide() or any configure_from_args() without the name."""
    _hidden.add(component)
    get_logger(component).setLevel(logging.CRITICAL + 1)


def unhide(component: str) -> None:
    _hidden.discard(component)
    get_logger(component).setLevel(logging.NOTSET)


def add_verbosity_flags(ap) -> None:
    """The shared CLI surface: -v/--verbose (repeatable), -q/--quiet
    (repeatable), --hide NAME (repeatable)."""
    ap.add_argument("-v", "--verbose", action="count", default=0)
    ap.add_argument("-q", "--quiet", action="count", default=0)
    ap.add_argument("--hide", action="append", default=[],
                    metavar="COMPONENT")


def configure_from_args(args) -> logging.Logger:
    root = configure(args.verbose - args.quiet)
    for c in list(_hidden):  # reconfiguration clears prior hides
        unhide(c)
    for c in args.hide:
        hide(c)
    return root
