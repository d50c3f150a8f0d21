"""Emitter front end: plan a spec's blocks, pad, run its hand kernel, crop.

The JAX package lowers every scheduled nest through one of four Pallas
templates in ``src/repro/codegen/emit.py``:

  * K1 ``_emit_streaming``        — elementwise / stencil / free-axis nests
  * K2 ``_emit_reduction``        — vector-axis reductions per stride row
  * K3 ``_emit_stream_reduction`` — the stride axis itself is reduced
  * K4 ``_emit_manual``           — explicit ``lookahead``-deep DMA rings

On Hopper each *instance* of a template (a template plus one family's
spec body) is a CUDA kernel written by hand (``csrc/``).  This front end
keeps everything around the template that is not the kernel: the block
plan (D streams, bm rows, bn lanes), the §5.1.2 pad-and-crop of the
operands, the §5.1.1 loop blocking of 1-D nests into a 2-D tile grid
(:func:`block_1d`), and the template's refusals.  It then hands the padded
operands and the :class:`~repro_torch.codegen.transforms.BlockPlan` to
the kernel registered for the spec's name in :data:`HAND_KERNELS`, or,
for a spec the JAX package lowers through K4, to the K4 ring
(``kernels/manual.py``), which takes the bodies in its ``BODIES``.  A
spec with no ported kernel raises ``NotImplementedError`` naming the
template and the instance still to port — there is no silent fallback
to the plain version.

``mode="ref"`` runs :func:`~repro_torch.codegen.loopir.evaluate`, the
plain PyTorch version, on whatever device the inputs lie on.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.codegen import loopir, transforms
from repro_torch.core.striding import StridingConfig

__all__ = ["HAND_KERNELS", "template_of", "hand_module", "block_1d",
           "check_config", "emit_spec", "run_spec", "shape_key", "gate",
           "guarded", "make_kernel_op"]

# spec name → module whose ``emit(spec, bp, arrays, scalars, config)``
# launches the hand-written K1-K3 kernel for that instance (imported at
# first use); K4 specs go to _MANUAL whatever their name
HAND_KERNELS = {
    "rmsnorm": "repro_torch.kernels.rmsnorm.kernel",
    "decode_attn_spec": "repro_torch.kernels.decode_attn.kernel",
    "decode_attn_masked": "repro_torch.kernels.decode_attn.kernel",
    "mxv": "repro_torch.kernels.mxv.kernel",
    "bicg_q": "repro_torch.kernels.mxv.kernel",
    "mxv_t": "repro_torch.kernels.mxv.kernel",
    "bicg_s": "repro_torch.kernels.mxv.kernel",
    "gemver_outer": "repro_torch.kernels.gemver.kernel",
    "gemver_sum": "repro_torch.kernels.gemver.kernel",
    "stream_copy": "repro_torch.kernels.stream.kernel",
    "stream_triad": "repro_torch.kernels.stream.kernel",
    "stream_init": "repro_torch.kernels.stream.kernel",
    "stream_read": "repro_torch.kernels.stream.kernel",
    "jacobi2d": "repro_torch.kernels.stencil",
    "conv3x3": "repro_torch.kernels.stencil",
    "doitgen": "repro_torch.kernels.doitgen.kernel",
    "adamw_update": "repro_torch.kernels.adamw.kernel",
    "gemver_mxv2": "repro_torch.kernels.mxv.kernel",
    "gemver_mxv1": "repro_torch.kernels.mxv.kernel",
    "gemver_mxv1_sum": "repro_torch.kernels.mxv.kernel",
    "rowstat": "repro_torch.kernels.gen.kernel",
    "transpose": "repro_torch.kernels.gen.kernel",
}
_MANUAL = "repro_torch.kernels.manual"

_TEMPLATES = {
    "K1": "_emit_streaming (src/repro/codegen/emit.py:410)",
    "K2": "_emit_reduction (src/repro/codegen/emit.py:491)",
    "K3": "_emit_stream_reduction (src/repro/codegen/emit.py:564)",
    "K4": "_emit_manual (src/repro/codegen/emit.py:708)",
}


def _write_rest(acc: loopir.Access, info: loopir.NestInfo) -> tuple:
    """A write's non-batch index vars, in declared order."""
    return tuple(v for v in acc.index if v not in info.batch_axes)


def _manual_eligible(spec: loopir.TraversalSpec,
                     info: loopir.NestInfo) -> bool:
    """The JAX template K4 takes plain ``(stride, vector)`` reads and
    ``(stride, vector)`` or ``(stride,)`` writes only."""
    if (info.reduction or info.stride_reduction
            or info.batch_axes or info.free_axes
            or info.row_halo != (0, 0) or info.col_halo != (0, 0)):
        return False
    sv = (info.stride_axis, info.vector_axis)
    if not all(a.index == sv and not a.has_halo for a in spec.reads):
        return False
    return all(w.index in (sv, (info.stride_axis,)) for w in spec.writes)


def template_of(spec: loopir.TraversalSpec, config: StridingConfig,
                info: Optional[loopir.NestInfo] = None) -> str:
    """Which of the JAX package's four Pallas templates lowers ``spec``
    under ``config`` (the selection rule of its ``emit_scheduled``; 1-D
    nests are loop-blocked into 2-D first, §5.1.1).  ``info`` is
    ``loopir.classify(spec)`` where the caller has it already."""
    if info is None:
        info = loopir.classify(spec)
    if info.blocked:
        return "K4" if config.lookahead != 2 else "K1"
    if info.stride_reduction:
        return "K3"
    if info.reduction and all(_write_rest(w, info) == (info.stride_axis,)
                              for w in spec.writes):
        return "K2"
    if config.lookahead != 2 and _manual_eligible(spec, info):
        return "K4"
    return "K1"


def _refuse(spec: loopir.TraversalSpec, bp: transforms.BlockPlan,
            template: str) -> None:
    """What the JAX package's ``emit_spec`` and its templates refuse, with
    the same exception types on the same conditions
    (``src/repro/codegen/emit.py``: ``emit_spec`` :939-955, K3 :576-600,
    ``emit_scheduled`` :845-854)."""
    info = bp.info
    rows = spec.axis(info.stride_axis).extent
    if info.stride_reduction and bp.rows != rows:
        # zero-padded rows would have to contribute the combine identity
        # through the body, which no generic body guarantees (and max /
        # online_softmax structurally cannot) — refuse rather than
        # silently corrupt, for EVERY combinator
        raise ValueError(
            f"{spec.name}: a stride-axis reduction cannot pad the stride "
            f"axis ({rows} rows, D={bp.d}); pick a D dividing the extent")
    cols = spec.axis(info.vector_axis).extent
    if (info.reduction and bp.cols != cols
            and any(c.name != "sum" for c in spec.combines())):
        # zero-padded vector lanes feed the body's reduction: harmless
        # for sums, but they poison any non-'sum' combinator (a padded
        # zero beats every negative row max)
        raise ValueError(
            f"{spec.name}: padding the reduced vector axis ({cols} -> "
            f"{bp.cols}) feeds zeros into a non-'sum' per-write "
            "combinator; use a lane-multiple extent or full_width=True")
    if template == "K3":
        if isinstance(spec.reduce, tuple):
            raise NotImplementedError(
                f"{spec.name}: per-write combinators on a stride-axis "
                "reduction (all D streams merge ONE shared state); use a "
                "scalar or finalizing combinator")
        comb = spec.combine
        if len(spec.writes) > 1 and not (comb.n_state > 1
                                         or comb.finalizing):
            raise NotImplementedError(
                f"{spec.name}: a multi-output stride reduction needs a "
                f"finalizing combinator producing one block per write; "
                f"{comb.name!r} finalizes the accumulated state "
                "identically")
    elif template != "K2":
        if isinstance(spec.reduce, tuple):
            raise NotImplementedError(
                f"{spec.name}: per-write combinators only apply to vector-"
                "axis reductions whose writes are all per-row (stride,) "
                "outputs — this nest lowers to the streaming/manual path, "
                "where no cross-block merge happens")
        if info.reduction and bp.bn != bp.cols:
            raise NotImplementedError(
                f"{spec.name}: a body-contracted reduction axis needs "
                "full_width=True")


def hand_module(spec: loopir.TraversalSpec, t: str) -> str:
    """The module of the kernel that runs ``spec`` under template ``t``
    (its ``emit`` launches it; its ``smem_of``, where it has one, gives
    the dynamic shared memory the launch requests)."""
    if t == "K4":
        manual = importlib.import_module(_MANUAL)
        path = _MANUAL if spec.name in manual.BODIES else None
    else:
        path = HAND_KERNELS.get(spec.name)
    if path is None:
        raise NotImplementedError(
            f"{spec.name}: no hand-written Hopper kernel — its TPU kernel "
            f"would be template {t} {_TEMPLATES[t]} with the "
            f"{spec.name!r} body, an instance the port has no kernel of "
            "(every spec of the JAX package has one). Use mode='ref' for "
            "the plain version.")
    return path


def _hand_kernel(spec: loopir.TraversalSpec, t: str) -> Callable:
    """The ``emit`` of the kernel that runs ``spec`` under template
    ``t``."""
    return importlib.import_module(hand_module(spec, t)).emit


# ---------------------------------------------------- pad / crop / run

def _pad_dim(x: torch.Tensor, dim: int, target: int) -> torch.Tensor:
    if x.shape[dim] == target:
        return x
    pads = [0, 0] * x.ndim          # F.pad lists the LAST dim first
    pads[2 * (x.ndim - 1 - dim) + 1] = target - x.shape[dim]
    return F.pad(x, pads)


def _pad_arrays(spec: loopir.TraversalSpec, bp: transforms.BlockPlan,
                arrays: Sequence) -> list:
    """Zero-pad every operand to the BlockPlan's extents (§5.1.2
    divisibility — pad+crop instead of leftover loops).  Batch and free
    dims keep their natural extents."""
    info = bp.info
    targets = {info.stride_axis: bp.rows, info.vector_axis: bp.cols}
    padded = []
    for acc, x in zip(spec.reads, arrays):
        for dim, (var, (lo, hi)) in enumerate(zip(acc.index, acc.halo)):
            target = targets.get(var, spec.axis(var).extent) + lo + hi
            x = _pad_dim(x, dim, target)
        padded.append(x)
    return padded


def block_1d(spec: loopir.TraversalSpec, config: StridingConfig,
             info: Optional[loopir.NestInfo] = None,
             ) -> tuple[loopir.TraversalSpec, int]:
    """§5.1.1 loop blocking of a 1-D nest, as the JAX package's
    ``_emit_blocked``: the single axis of extent n is tiled into a
    ``[ceil(n / 128·P), 128·P]`` grid.  Returns the 2-D spec (its
    accesses remapped to ``(<axis>__blk, <axis>__lane)``) and n.
    ``info`` is ``loopir.classify(spec)`` where the caller has it
    already."""
    if info is None:
        info = loopir.classify(spec)
    ax = spec.axis(info.stride_axis)
    n = ax.extent
    cols = transforms.LANE * config.portion_unroll
    rows = max(-(-n // cols), 1)
    row_ax, lane_ax = ax.name + "__blk", ax.name + "__lane"

    def remap(acc):
        return dataclasses.replace(acc, index=(row_ax, lane_ax), halo=None)

    spec2 = dataclasses.replace(
        spec,
        axes=(loopir.Axis(row_ax, rows), loopir.Axis(lane_ax, cols)),
        reads=tuple(remap(a) for a in spec.reads),
        writes=tuple(remap(a) for a in spec.writes),
    )
    return spec2, n


def check_config(spec: loopir.TraversalSpec,
                 config: StridingConfig) -> None:
    """Raise what :func:`emit_spec` raises for ``(spec, config)`` before
    it touches an operand: the template's refusals (``_refuse``) and a
    spec with no hand kernel under the template the config selects.  The
    planner's gate (``core.planner.rank_configs(spec=...)``): a config
    this refuses is never ranked."""
    info = loopir.classify(spec)
    if info.blocked:
        spec, _ = block_1d(spec, config, info)
        info = loopir.classify(spec)
    bp = transforms.plan_blocks(spec, config, info=info)
    template = template_of(spec, config, info)
    _refuse(spec, bp, template)
    _hand_kernel(spec, template)


def _emit_blocked(spec: loopir.TraversalSpec, info: loopir.NestInfo,
                  arrays: Sequence, scalars: Sequence,
                  config: StridingConfig):
    """Run a 1-D nest on its :func:`block_1d` tiling: pad each operand
    to whole tiles, run the 2-D spec's pipeline, crop back to n."""
    spec2, n = block_1d(spec, config, info)
    rows, cols = (ax.extent for ax in spec2.axes)

    def to2d(x):
        return _pad_dim(x, 0, rows * cols).reshape(rows, cols)

    out = emit_spec(spec2, [to2d(x) for x in arrays] + list(scalars),
                    config)
    outs = out if isinstance(out, tuple) else (out,)
    res = tuple(o.reshape(-1)[:n] for o in outs)
    return res[0] if len(res) == 1 else res


def emit_spec(spec: loopir.TraversalSpec, inputs: Sequence,
              config: StridingConfig, device=None):
    """The whole pipeline for one call on the card: plan blocks → refuse
    what the template refuses → pad operands → hand kernel → crop to
    the original domain.  1-D nests are loop-blocked into a 2-D tile
    grid first (§5.1.1).  A writes-only spec has no operand to take a
    device from: its kernel makes its output on ``device``."""
    n = len(spec.reads)
    if len(inputs) != n + len(spec.scalars):
        raise ValueError(f"{spec.name}: expected {n} arrays + "
                         f"{len(spec.scalars)} scalars")
    arrays, scalars = list(inputs[:n]), list(inputs[n:])
    info = loopir.classify(spec)        # once, shared by the steps below
    if info.blocked:
        return _emit_blocked(spec, info, arrays, scalars, config)
    bp = transforms.plan_blocks(spec, config, info=info)
    template = template_of(spec, config, info)
    _refuse(spec, bp, template)
    kernel = _hand_kernel(spec, template)
    arrays = _pad_arrays(spec, bp, arrays)
    targets = {bp.info.stride_axis: bp.rows, bp.info.vector_axis: bp.cols}
    spec_p = dataclasses.replace(spec, axes=tuple(
        dataclasses.replace(ax, extent=targets.get(ax.name, ax.extent))
        for ax in spec.axes))
    if spec.reads:
        out = kernel(spec_p, bp, arrays, scalars, config)
    else:
        if device is None:
            raise ValueError(f"{spec.name}: a writes-only spec needs the "
                             "device to make its output on")
        out = kernel(spec_p, bp, arrays, scalars, config,
                     device=torch.device(device))
    outs = out if isinstance(out, tuple) else (out,)
    res = tuple(o[tuple(slice(0, s) for s in shape)]
                for o, shape in zip(outs, spec.out_shapes()))
    return res[0] if len(res) == 1 else res


def _dispatch(spec: loopir.TraversalSpec, inputs: Sequence,
              config: StridingConfig, mode: Optional[str], device):
    # imported here: the kernels package imports the codegen at its top
    from repro_torch.kernels import common
    if device is None:
        if not spec.reads:
            raise ValueError(f"{spec.name}: a writes-only spec needs an "
                             "explicit device")
        device = inputs[0].device
    device = torch.device(device)
    if common.kernel_mode(device, mode) == "ref":
        return loopir.evaluate(spec, inputs, device=device)
    return emit_spec(spec, inputs, config, device=device)


def run_spec(build_spec: Callable[..., loopir.TraversalSpec],
             inputs: Sequence, config: StridingConfig,
             mode: Optional[str] = None, device=None):
    """Device-dispatched spec execution: ``mode="ref"`` (or CPU inputs)
    runs the plain PyTorch version; CUDA inputs run the hand kernel or
    raise.  The route follows the first input's device, or ``device``
    where it is given; a writes-only spec (whose inputs are scalars
    only) must give it."""
    return _dispatch(build_spec(*inputs), inputs, config, mode, device)


def shape_key(inputs: Sequence) -> tuple:
    """What a spec built from ``inputs`` depends on: each tensor's shape
    and dtype (a scalar: None)."""
    return tuple((tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor)
                 else None for x in inputs)


def gate(kernel: str, verdicts: dict, key, specs, config: StridingConfig,
         dtype) -> None:
    """The static verifier's gate before a launch on the card: raise an
    ``AnalysisError`` when ``analysis.ensure_valid(kernel, specs, config,
    dtype=dtype)`` rejects the plan.  The error findings (none when it
    passes) are memoized in ``verdicts`` per ``(key, config)``, ``key``
    the call's shape key, and a fresh error is raised on every hit, so
    the memo holds no traceback.  After a shape's first call at a config
    the gate is a dict lookup."""
    vkey = (key, config)
    errs = verdicts.get(vkey)
    if errs is None:
        from repro_torch import analysis   # deferred: analysis imports us
        try:
            analysis.ensure_valid(kernel, specs, config, dtype=dtype)
            errs = ()
        except analysis.AnalysisError as err:
            errs = err.findings
        verdicts[vkey] = errs
    if errs:
        from repro_torch.analysis import AnalysisError
        raise AnalysisError(kernel, errs)


def guarded(kernel: str) -> Callable:
    """The screened and guarded launch of one op, as the JAX package's
    ``make_kernel_op`` and ``polybench._guarded`` run theirs:
    ``dispatch(run, inputs, build, cfg, mode, rows, traffic)`` calls
    ``run(config)`` inside ``kernels.common.guarded_run``, and before
    each launch on the card :func:`gate` screens ``build()`` — the spec,
    or the tuple of specs, the call runs, built once per shape key of
    ``inputs`` — at that config.  ``rows`` and ``traffic`` give the
    guard its alternatives.  ``mode="ref"`` and CPU inputs skip both.
    Each op keeps its own specs and verdicts."""
    from repro_torch.kernels import common   # the kernels import codegen

    specs_of: dict[tuple, object] = {}       # shape key → spec(s)
    verdicts: dict[tuple, tuple] = {}        # (shape key, config) → errors

    def dispatch(run: Callable, inputs: Sequence, build: Callable,
                 cfg: StridingConfig, mode: Optional[str],
                 rows: Optional[int], traffic):
        lead = inputs[0]
        key = shape_key(inputs)
        specs = specs_of.get(key)
        if specs is None:
            specs = specs_of[key] = build()

        def attempt(c: StridingConfig, m: str):
            if m != "ref":
                gate(kernel, verdicts, key, specs, c, lead.dtype)
            return run(c)

        return common.guarded_run(
            kernel, attempt, cfg, common.kernel_mode(lead, mode),
            shape=lead.shape, dtype=lead.dtype, device=lead.device,
            rows=rows, traffic=traffic, spec=specs)

    return dispatch


def make_kernel_op(name: str,
                   build_spec: Callable[..., loopir.TraversalSpec],
                   default: StridingConfig = StridingConfig(4, 1),
                   ) -> Callable:
    """Wrap a spec builder as a public kernel op, as the JAX package's
    ``make_kernel_op`` (``src/repro/codegen/emit.py:990``):
    ``op(*arrays, *scalars, config=None, mode=None)``, config resolution
    (explicit > tuned > planned > default, ``kernels.common.
    resolve_config``; the spec's Traffic goes to the planner only when
    no config is given, and the spec gates the planner's candidates
    through the static verifier and :func:`check_config`) and device
    dispatch (:func:`run_spec`: the hand kernel on the card, the plain
    version on the CPU or with ``mode="ref"``).

    A launch on the card is screened and guarded (:func:`guarded`), as
    in the JAX package.  Before it the static verifier
    (``repro_torch.analysis``) must pass the (spec, config, dtype)
    triple (:func:`gate`): a rejected plan raises ``AnalysisError`` with
    nothing launched.  The launch runs inside ``kernels.common.
    guarded_run``: a config that fails (the gate's rejection included)
    is classified and quarantined in the tune cache, and up to two
    next-ranked configs of the same hand kernel are tried, with a
    ``kernel.fallback`` event; when none is left the original exception
    is raised.  No tier runs the plain version, and
    a kernel that does not build or a poisoned CUDA context re-raises at
    once.  ``mode="ref"`` and CPU inputs skip the gate and the guard.

    The spec, the stride extent the clamp uses and the Traffic signature
    are pure in the input shapes and dtypes, and memoized per shape key;
    the gate's verdicts per (shape key, config)."""
    # imported here: the kernels package imports the codegen at its top
    from repro_torch import obs
    from repro_torch.kernels import common

    facts: dict[tuple, tuple] = {}     # shape key → (rows, traffic, spec)
    dispatch = guarded(name)

    def op(*inputs, config: Optional[StridingConfig] = None,
           mode: Optional[str] = None):
        key = shape_key(inputs)
        if key not in facts:
            obs.counter("codegen.spec_memo.miss", kernel=name)
            spec = build_spec(*inputs)
            info = loopir.classify(spec)
            # blocked 1-D nests derive their tile grid from the config —
            # pad+crop makes any D valid, so no divisibility clamp
            rows = (None if info.blocked
                    else spec.axis(info.stride_axis).extent)
            facts[key] = (rows, loopir.traffic_of(spec, inputs[0].dtype,
                                                  info=info), spec)
        else:
            obs.counter("codegen.spec_memo.hit", kernel=name)
        rows, traffic, spec = facts[key]
        lead = inputs[0]
        cfg = common.resolve_config(
            name, lead.shape, lead.dtype, config, rows, default,
            traffic=(None if config is not None else traffic),
            mode=common.kernel_mode(lead, mode), device=lead.device,
            spec=spec)
        return dispatch(lambda c: _dispatch(spec, inputs, c, mode, None),
                        inputs, lambda: spec, cfg, mode, rows, traffic)

    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = (f"Generated multi-strided kernel {name!r} (repro_torch."
                  "codegen: spec → block plan → hand kernel).")
    return op
