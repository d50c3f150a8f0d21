"""Finding/rule vocabulary for the static verifier (`repro_torch.analysis`).

The JAX package's rule ids, severities and exception, kept as the port's
own copy (``src/repro/analysis/findings.py``; the port imports nothing of
that package).  Stdlib only: ``kernels.common.classify_failure`` imports
it on every guarded failure, so it must never pull the codegen or the
planner in.

A :class:`Finding` is one statically-proven (or statically-suspected)
defect of a ``(spec, schedule, plan)`` triple: a rule id, a severity,
the spec it anchors to, a locus (the offending write/read/axis or the
config), and a human message.  ``error`` findings reject the plan
before any launch (:class:`AnalysisError`); ``warning`` findings ride
the report but do not gate.

RES001 is the card's rule, not the TPU's: a plan's dynamic shared
memory, from the geometry its launcher uses, against what one block may
opt into (``roofline.hw.H100_HW.block_smem``).
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "Finding", "AnalysisError", "RULES", "errors", "warnings",
    "SPEC001", "SPEC002", "SPEC003", "SPEC004",
    "RACE001", "RACE002", "RACE003", "RACE004",
    "BOUNDS001", "BOUNDS002", "BOUNDS003", "BOUNDS004",
    "RES001", "NUM001",
]

# --- spec-validation rules (mirrored as literal ids in loopir messages)
SPEC001 = "SPEC001"   # write access map repeats an axis
SPEC002 = "SPEC002"   # write access map indexes a reduced axis
SPEC003 = "SPEC003"   # write access map omits a batch axis
SPEC004 = "SPEC004"   # spec.write/out_shape() ambiguous on multi-write

# --- write-race / alias rules
RACE001 = "RACE001"   # write map omits the stride axis (row steps race)
RACE002 = "RACE002"   # write map omits the vector axis w/o whole rows
RACE003 = "RACE003"   # per-write combinators race partial accumulators
RACE004 = "RACE004"   # permuted store aliases a read of the same array

# --- bounds / halo / pad-contract rules
BOUNDS001 = "BOUNDS001"   # tap offset outside the declared halo
BOUNDS002 = "BOUNDS002"   # schedule does not cover the domain once
BOUNDS003 = "BOUNDS003"   # stride-axis reduction cannot pad the stride
BOUNDS004 = "BOUNDS004"   # padded reduced lanes under a non-'sum' fold

# --- resource / numerics rules
RES001 = "RES001"     # dynamic shared memory exceeds a block's opt-in
NUM001 = "NUM001"     # interleaved sub-portions reassociate a reduction

# rule id -> (one-line description, default severity)
RULES: dict[str, tuple[str, str]] = {
    SPEC001: ("write access map repeats an axis", "error"),
    SPEC002: ("write access map indexes a reduced axis", "error"),
    SPEC003: ("write access map omits a batch axis", "error"),
    SPEC004: ("spec.write/out_shape() is ambiguous on a multi-write "
              "spec", "error"),
    RACE001: ("write map omits the stride axis: every row grid step and "
              "D stream stores the same index", "error"),
    RACE002: ("write map omits (or contracts) the vector axis without "
              "whole rows: column grid steps store partial values to "
              "the same index", "error"),
    RACE003: ("per-write combinators have no shared merge under this "
              "schedule: D partial accumulators race", "error"),
    RACE004: ("permuted store aliases a read of the same array "
              "(read-after-write hazard in a destination-passing "
              "lowering)", "error"),
    BOUNDS001: ("tap offset outside the declared halo: the read escapes "
                "the padded extent", "error"),
    BOUNDS002: ("schedule does not cover the iteration domain exactly "
                "once", "error"),
    BOUNDS003: ("stride-axis reduction cannot pad the stride axis: D "
                "must divide the reduced extent", "error"),
    BOUNDS004: ("padding the reduced vector axis feeds zeros into a "
                "non-'sum' combinator", "error"),
    RES001: ("the launcher's dynamic shared memory exceeds what one "
             "block may opt into (or its geometry refuses the plan)",
             "error"),
    NUM001: ("interleaved lane sub-portion folds reassociate a "
             "non-full-width reduction", "warning"),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One statically-decided defect of a (spec, schedule, plan) triple."""

    rule: str        # e.g. "RACE001" (a RULES key)
    severity: str    # "error" | "warning"
    spec: str        # spec name the finding anchors to
    locus: str       # offending write/read/axis/config, human-readable
    message: str     # full sentence, names the array and the geometry

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def errors(findings) -> list:
    return [f for f in findings if f.severity == "error"]


def warnings(findings) -> list:
    return [f for f in findings if f.severity == "warning"]


class AnalysisError(Exception):
    """A plan the static verifier rejected (error-severity findings).

    Deliberately not a ValueError: ``kernels.common.classify_failure``
    maps this type to the ``analysis`` failure class, distinct from
    ``invalid_config``, and checks it before its resource markers (a
    RES001 message names shared memory)."""

    def __init__(self, kernel: str, findings):
        self.kernel = kernel
        self.findings = tuple(findings)
        rules = ", ".join(sorted({f.rule for f in self.findings}))
        detail = "; ".join(f"[{f.rule}] {f.message}" for f in self.findings)
        super().__init__(
            f"{kernel}: static analysis rejected the plan ({rules}): "
            f"{detail}")
