"""Static verifier over the codegen IR: races, bounds, shared memory,
numerics — the JAX package's ``repro.analysis.checker`` for the card.

Four analyses over a ``(spec, config)`` pair, none of which launches or
allocates anything on a device:

  * **write-race/alias** (RACE001–RACE004), as the JAX checker has them:
    compose each write access map with the block plan ``plan_blocks``
    derives (stride split into D streams × row steps × column steps) and
    prove every (write array, store index) pair is produced by exactly
    one (grid step × stream × lane) point.  These rules prove the
    *plan's* write maps.  They do not see inside a hand kernel: a race
    between the threads of one block on its shared memory (such as the
    row table ``csrc/doitgen.cu`` ``doitgen_f32`` rewrites each pass)
    is invisible to them, and ``compute-sanitizer --tool racecheck``
    does not run on the card's machine; such races are found by reading
    the kernel and by its card tests against the plain version.
  * **bounds/halo** (BOUNDS001–BOUNDS004), as the JAX checker has them:
    evaluate the body on ``device="meta"`` tensors of the halo-widened
    block shapes (``loopir.tap`` raises outside its declared halo; no
    data is made and nothing runs), prove the derived schedule covers
    the padded iteration domain exactly once (the interval proof of
    ``transforms.preserves_domain``), and check the §5.1.2 pad contract.
  * **shared memory** (RES001), redone for the card: the dynamic shared
    memory the instance's launcher would request, from the same
    pure-Python geometry function that launcher calls (each hand-kernel
    module's ``smem_of``: the K4 ring's ``manual.ring_tile`` /
    ``ring_smem``, the K2 row-dot's ``mxv.kernel.rowdot_geometry``,
    doitgen's ``geometry``, rmsnorm's cluster ``geometry``, decode's TMA
    stages), against what one block may opt into
    (``roofline.hw.H100_HW.block_smem``).  A geometry that refuses the
    plan (a ring with no tile that fits, a row no cluster holds) is a
    RES001 finding too; an instance that takes no dynamic shared memory
    gives none.  Registers cannot be known before ``ptxas`` runs, so no
    rule checks them: ``chip_smoke.py``'s build phase prints every
    instance's registers and spills (its ``ptxas ... instances`` line)
    and fails the run on a spill where one would cost.
  * **numerics lint** (NUM001), as the JAX checker has it: an
    interleaved lane arrangement over a non-``full_width`` reduced row.
    A warning (the kernels fold sub-portions in grouped order); pass
    ``assume_grouped_fold=False`` to make it an error.

Entry points: :func:`check` returns findings; :func:`ensure_valid`
additionally emits ``analysis.pass`` / ``analysis.violation`` events
and raises :class:`~repro_torch.analysis.findings.AnalysisError` on an
error-severity finding — the exception ``kernels.common.
classify_failure`` maps to the ``analysis`` failure class.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Sequence, Union

import torch

from repro_torch import obs
from repro_torch.analysis import findings as F
from repro_torch.analysis.findings import AnalysisError, Finding
from repro_torch.codegen import loopir, transforms
from repro_torch.core.striding import StridingConfig
from repro_torch.roofline.hw import H100_HW

__all__ = ["check", "ensure_valid", "dynamic_smem", "AnalysisError",
           "Finding", "SMEM_BUDGET"]

# what one block may opt into on the card
SMEM_BUDGET = H100_HW.block_smem

SpecLike = Union[loopir.TraversalSpec, Sequence[loopir.TraversalSpec]]


def _specs_of(spec: SpecLike) -> tuple[loopir.TraversalSpec, ...]:
    if isinstance(spec, loopir.TraversalSpec):
        return (spec,)
    return tuple(spec)


def _rest(acc: loopir.Access, info: loopir.NestInfo) -> tuple[str, ...]:
    """Non-batch index vars of an access, in declared order."""
    return tuple(v for v in acc.index if v not in info.batch_axes)


# ------------------------------------------------- config-independent

def _alias_findings(spec: loopir.TraversalSpec) -> list[Finding]:
    """RACE004: a store into an array the body also reads, under a
    different index map — the transposed/permuted-store RAW hazard."""
    out = []
    reads = {a.array: a for a in spec.reads}
    for w in spec.writes:
        r = reads.get(w.array)
        if r is not None and tuple(r.index) != tuple(w.index):
            out.append(Finding(
                F.RACE004, "error", spec.name, f"write {w.array!r}",
                f"write {w.array!r} {w.index} aliases the read of "
                f"{r.array!r} {r.index} under a permuted index map: "
                "stores land in cells later loop points still read"))
    return out


def _halo_findings(spec: loopir.TraversalSpec) -> list[Finding]:
    """BOUNDS001: every read block is presented at its halo-widened shape
    ``extent + lo + hi`` per dim as a ``meta`` tensor; a ``tap`` whose
    offset escapes the declared ``[-lo, +hi]`` window raises while the
    body runs on shapes alone."""
    meta = dict(dtype=torch.float32, device="meta")
    env = {}
    for acc in spec.reads:
        shape = tuple(spec.axis(v).extent + lo + hi
                      for v, (lo, hi) in zip(acc.index, acc.halo))
        env[acc.array] = torch.empty(shape, **meta)
    for name in spec.scalars:
        env[name] = torch.empty((), **meta)
    try:
        spec.body(env)
    except ValueError as exc:
        msg = str(exc)
        if "outside halo" in msg or "tap offset" in msg:
            return [Finding(
                F.BOUNDS001, "error", spec.name, "body tap",
                f"body read escapes the declared halo: {msg} — the "
                "loaded block only includes the declared border, so "
                "this tap reads outside the padded extent")]
        # other ValueErrors are body/shape issues the plain-version
        # tests own, not halo violations
    except Exception:     # noqa: BLE001 — out of this analysis's scope
        # a body that cannot run on meta tensors at these shapes is
        # left to the kernels' tests against the plain version
        pass
    return []


# --------------------------------------------------- per-config checks

def _race_findings(spec, info, bp) -> list[Finding]:
    out = []
    all_row = all(_rest(w, info) == (info.stride_axis,)
                  for w in spec.writes)
    vecred = info.reduction and all_row
    if isinstance(spec.reduce, tuple) and not vecred:
        # per-write accumulators only merge on the vector-axis-reduction
        # path; under a stride split of a reduced axis, or on the
        # streaming path, each of the D streams folds its own partial
        # and the last store wins
        out.append(Finding(
            F.RACE003, "error", spec.name,
            f"reduce={tuple(getattr(r, 'name', r) for r in spec.reduce)}",
            f"per-write combinators on this nest race D={bp.d} partial "
            "accumulators: the stride split gives every stream its own "
            "fold with no cross-stream merge on this lowering path"))
    if vecred or info.stride_reduction:
        if info.stride_reduction:
            for w in spec.writes:
                rest = _rest(w, info)
                if rest != (info.vector_axis,) and bp.bn != bp.cols:
                    out.append(Finding(
                        F.RACE002, "error", spec.name, f"write {w.array!r}",
                        f"write {w.array!r} {w.index} does not split over "
                        f"the vector axis, but the schedule runs "
                        f"{bp.cols // bp.bn} column grid steps "
                        f"(bn={bp.bn} < cols={bp.cols}): each step "
                        "finalizes and stores a column-partial value to "
                        "the same index — set full_width=True"))
        return out
    # streaming path: every (row step × stream × column step) must hit a
    # distinct store index
    n_row_writers = bp.rows            # d streams × (rows/d) row steps
    n_col_steps = bp.cols // bp.bn
    for w in spec.writes:
        rest = _rest(w, info)
        if info.stride_axis not in rest:
            if n_row_writers > 1:
                out.append(Finding(
                    F.RACE001, "error", spec.name, f"write {w.array!r}",
                    f"write {w.array!r} {w.index} omits the stride axis "
                    f"{info.stride_axis!r}: all {n_row_writers} "
                    f"(row step × D={bp.d} stream) points store to the "
                    "same index — the batch-wide cache-clobber shape"))
            continue
        if info.vector_axis not in rest and n_col_steps > 1:
            out.append(Finding(
                F.RACE002, "error", spec.name, f"write {w.array!r}",
                f"write {w.array!r} {w.index} omits the vector axis "
                f"{info.vector_axis!r} while the schedule runs "
                f"{n_col_steps} column grid steps (bn={bp.bn} < "
                f"cols={bp.cols}): each step stores a partial row "
                "statistic to the same index — set full_width=True"))
    return out


def _pad_findings(spec, info, bp) -> list[Finding]:
    out = []
    rows = spec.axis(info.stride_axis).extent
    cols = spec.axis(info.vector_axis).extent
    if info.stride_reduction and bp.rows != rows:
        out.append(Finding(
            F.BOUNDS003, "error", spec.name,
            f"axis {info.stride_axis!r}",
            f"stride-axis reduction over {info.stride_axis!r} "
            f"(extent {rows}) cannot pad to {bp.rows}: padded rows "
            "would have to contribute the combine identity through the "
            f"body; pick a D dividing the extent (D={bp.d} does not)"))
    if (info.reduction and bp.cols != cols
            and any(c.name != "sum" for c in spec.combines())):
        out.append(Finding(
            F.BOUNDS004, "error", spec.name,
            f"axis {info.vector_axis!r}",
            f"padding the reduced vector axis ({cols} -> {bp.cols}) "
            "feeds zeros into a non-'sum' combinator (a padded zero "
            "beats every negative row max); use a lane-multiple extent "
            "or full_width=True"))
    return out


def _domain_findings(spec, info, bp, config) -> list[Finding]:
    """BOUNDS002: the §5.1 schedule at padded extents must cover the
    padded iteration domain exactly once (interval proof, any extent)."""
    targets = {info.stride_axis: bp.rows, info.vector_axis: bp.cols}
    padded = dataclasses.replace(spec, axes=tuple(
        dataclasses.replace(ax, extent=targets.get(ax.name, ax.extent))
        for ax in spec.axes))
    try:
        sched = transforms.default_schedule(padded, config, blocks=bp)
    except (ValueError, NotImplementedError):
        return []      # schedule construction itself refuses loudly
    if not transforms.preserves_domain(sched):
        return [Finding(
            F.BOUNDS002, "error", spec.name, f"config {config}",
            f"the derived schedule does not cover the padded iteration "
            f"domain (rows={bp.rows}, cols={bp.cols}) exactly once")]
    return []


def dynamic_smem(spec: loopir.TraversalSpec, config: StridingConfig,
                 dtype=torch.float32, sms: int = H100_HW.sms,
                 info: Optional[loopir.NestInfo] = None,
                 bp: Optional[transforms.BlockPlan] = None) -> int:
    """Bytes of dynamic shared memory the launcher of ``spec``'s instance
    under ``config`` requests for operands of ``dtype`` on a card of
    ``sms`` SMs: the ``smem_of`` of the hand-kernel module the emitter
    picks (0 for a module without one: its instance takes none).
    Raises ``ValueError`` where that geometry refuses the plan and
    ``NotImplementedError`` where the emitter has no kernel for it.
    ``spec`` is a 2-D nest (a 1-D one after ``emit.block_1d``)."""
    from repro_torch.codegen import emit   # deferred: emit imports us
    if info is None:
        info = loopir.classify(spec)
    if bp is None:
        bp = transforms.plan_blocks(spec, config, info=info)
    mod = emit.hand_module(spec, emit.template_of(spec, config, info))
    smem_of = getattr(importlib.import_module(mod), "smem_of", None)
    return 0 if smem_of is None else smem_of(spec, bp, config, dtype, sms)


def _resource_findings(spec, info, bp, config, dtype) -> list[Finding]:
    locus = f"config {config}"
    try:
        need = dynamic_smem(spec, config, dtype, info=info, bp=bp)
    except NotImplementedError:
        return []       # no kernel for the plan: the emitter refuses it
    except ValueError as exc:
        return [Finding(
            F.RES001, "error", spec.name, locus,
            f"the launcher's geometry refuses the plan (D={bp.d}, "
            f"bm={bp.bm}, bn={bp.bn}, lookahead={config.lookahead}, "
            f"{dtype}): {exc}")]
    if need <= SMEM_BUDGET:
        return []
    return [Finding(
        F.RES001, "error", spec.name, locus,
        f"dynamic shared memory of {need} bytes exceeds the {SMEM_BUDGET} "
        f"bytes one block may opt into (D={bp.d}, bm={bp.bm}, "
        f"bn={bp.bn}, lookahead={config.lookahead}, {dtype})")]


def _numerics_findings(spec, info, bp, config,
                       assume_grouped_fold: bool) -> list[Finding]:
    all_row = all(_rest(w, info) == (info.stride_axis,)
                  for w in spec.writes)
    vecred = info.reduction and all_row
    if not (vecred and config.arrangement == "interleaved"
            and not spec.full_width and bp.bn > transforms.LANE):
        return []
    sev = "warning" if assume_grouped_fold else "error"
    tail = ("the kernels fold sub-portions in grouped order, so totals "
            "match the grouped order — but this schedule depends on it"
            if assume_grouped_fold else
            "a naive lane fold would sum maximally-spaced sub-portions "
            "in interleaved order and reassociate the reduction")
    return [Finding(
        F.NUM001, sev, spec.name, f"config {config}",
        f"interleaved P={config.portion_unroll} lane sub-portions of a "
        f"reduced row (bn={bp.bn} > {transforms.LANE}): {tail}")]


def _config_findings(spec, config, dtype,
                     assume_grouped_fold) -> list[Finding]:
    try:
        info = loopir.classify(spec)
    except (ValueError, NotImplementedError):
        return []       # nests classify itself refuses are not plans
    if info.blocked:
        # the emitter's §5.1.1 tiling: analyze the 2-D spec it lowers
        from repro_torch.codegen import emit
        spec2, _ = emit.block_1d(spec, config, info)
        return _config_findings(spec2, config, dtype, assume_grouped_fold)
    try:
        bp = transforms.plan_blocks(spec, config, info=info)
    except (ValueError, NotImplementedError):
        return []
    out = []
    out += _race_findings(spec, info, bp)
    out += _pad_findings(spec, info, bp)
    out += _domain_findings(spec, info, bp, config)
    out += _resource_findings(spec, info, bp, config, dtype)
    out += _numerics_findings(spec, info, bp, config, assume_grouped_fold)
    return out


# --------------------------------------------------------- entry points

def check(spec: SpecLike, config: Optional[StridingConfig] = None, *,
          dtype=torch.float32, assume_grouped_fold: bool = True,
          static: bool = True) -> list[Finding]:
    """Run every analysis over ``spec`` (a TraversalSpec or a tuple of
    them — composite ops run several) and, when ``config`` is given,
    over the block plan it implies for operands of ``dtype``.  Returns
    findings only — no exception, nothing launched.

    ``static=False`` skips the config-independent analyses (alias, halo
    probe): ``rank_configs`` runs those once per spec and only the
    per-config analyses per candidate."""
    out: list[Finding] = []
    for s in _specs_of(spec):
        if static:
            out += _alias_findings(s)
            out += _halo_findings(s)
        if config is not None:
            out += _config_findings(s, config, dtype, assume_grouped_fold)
    return out


def ensure_valid(kernel: str, spec: SpecLike,
                 config: Optional[StridingConfig] = None, *,
                 dtype=torch.float32,
                 assume_grouped_fold: bool = True) -> list[Finding]:
    """Gatekeeper for dispatch: run :func:`check`, record the verdict on
    the telemetry spine, and raise :class:`AnalysisError` when any
    error-severity finding rejects the plan — before any launch."""
    fs = check(spec, config, dtype=dtype,
               assume_grouped_fold=assume_grouped_fold)
    if obs.enabled():
        if fs:
            for f in fs:
                obs.event("analysis.violation", kernel=kernel, rule=f.rule,
                          severity=f.severity, spec=f.spec, locus=f.locus,
                          message=f.message)
        else:
            obs.event("analysis.pass", kernel=kernel,
                      specs=[s.name for s in _specs_of(spec)],
                      config=str(config))
    errs = F.errors(fs)
    if errs:
        raise AnalysisError(kernel, errs)
    return fs
