"""Static analysis over round code — the macro-time gate.

Port of round_tpu/analysis.  The reference inspects round closures before
they run and rejects ill-formed protocols statically (SURVEY §1,
Verifier.scala); this package is that gate for the torch port: every
registered model's send/update is traced (make_fx over the engine's vmap
of one round, on small example tensors on the card unless the caller
names a device) and its source is scanned by AST passes, producing typed
findings across five rule families (round_tpu's six less
tpu-lowerability, which read TPU dtype tables the port does not carry):

  comm-closure, recompile-hazard, purity, spec-coherence,
  threshold-extractable

runtimelint.py extends the gate to the SERVING tier (``--runtime``) with
five more families over the port's runtime/, kv/, snap/, rv/, obs/ and
native/transport.cpp:

  lock-discipline, wire-coherence, fold-determinism,
  counter-accounting, obs-vocab

CLI: ``python -m round_tpu_torch.apps.lint [--all|MODEL] [--runtime]
[--check-docs] [--json] [--baseline …] [--device …]``
Catalog + suppression workflow: docs/ANALYSIS.md.
"""

from round_tpu_torch.analysis.findings import (
    FAMILIES,
    Finding,
    Suppression,
    apply_baseline,
    default_baseline_path,
    default_runtime_baseline_path,
    load_baseline,
)
from round_tpu_torch.analysis.lint import lint_all, lint_model
from round_tpu_torch.analysis.registry import BY_NAME, REGISTRY, ModelEntry

__all__ = [
    "FAMILIES",
    "Finding",
    "Suppression",
    "apply_baseline",
    "default_baseline_path",
    "default_runtime_baseline_path",
    "load_baseline",
    "lint_all",
    "lint_model",
    "BY_NAME",
    "REGISTRY",
    "ModelEntry",
]
