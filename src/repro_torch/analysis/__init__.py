"""repro_torch.analysis — static verifier for specs, block plans and
launches, the JAX package's ``repro.analysis`` for the card.

Proves properties of a ``(TraversalSpec, StridingConfig)`` pair before
anything is launched: write races and aliases, halo bounds and the
pad-and-crop contract, the launcher's dynamic shared memory against
what one block may opt into, and reassociation-sensitive numerics.  See
:mod:`repro_torch.analysis.checker` for the analyses (and what the race
rules do not see) and :mod:`repro_torch.analysis.findings` for the rule
vocabulary.

Wired in at three layers: ``codegen.emit.make_kernel_op`` and the
composite ``*_gen`` ops gate every launch through :func:`ensure_valid`
(a rejected config is quarantined by ``kernels.common.guarded_run``
with failure class ``analysis``, with no launch), ``core.planner.
rank_configs`` drops rejected candidates, and ``tools/
torch_speclint.py`` runs the registry sweep, the fixtures and the
port's repo lint.
"""
from repro_torch.analysis.checker import check, ensure_valid
from repro_torch.analysis.findings import (RULES, AnalysisError, Finding,
                                           errors, warnings)

__all__ = ["check", "ensure_valid", "AnalysisError", "Finding", "RULES",
           "errors", "warnings"]
