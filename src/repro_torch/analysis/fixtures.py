"""Adversarial spec fixtures the static verifier must reject.

Each builder returns a :class:`Fixture`: a well-formed (constructible)
``TraversalSpec`` + ``StridingConfig`` pair that passes ``loopir``'s
local validation but carries exactly one statically-decidable defect,
plus the rule id the checker must flag it with.  Four are the JAX
package's (``src/repro/analysis/fixtures.py``) with torch bodies:

  * ``race``     — a per-slot cache write whose access map dropped the
    slot (stride) axis, so every slot stores the same row (RACE001);
  * ``redsplit`` — per-write combinators under a stride split of the
    reduced axis (RACE003);
  * ``halo``     — a stencil tap past its declared halo (BOUNDS001);
  * ``reassoc``  — an interleaved lane arrangement over a multi-portion
    reduced row (NUM001; an error under ``assume_grouped_fold=False``).

The JAX package's ``vmem`` fixture overflows a TPU's VMEM, a quantity
the card does not have.  ``smem`` replaces it with one that overflows
*on the card*: the stream copy at lookahead 4 on 16 streams of 8-row
blocks, a K4 ring whose narrowest (128-column) tile needs more dynamic
shared memory than one block may opt into (RES001); the ring's launcher
(``kernels.manual.ring_plan``) refuses it too.

``tools/torch_speclint.py --fixture <name>`` runs one of these and must
exit 1 with the expected rule id.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.analysis import findings as F
from repro_torch.codegen.loopir import Access, Axis, TraversalSpec, tap
from repro_torch.core.striding import StridingConfig

__all__ = ["Fixture", "FIXTURES", "build"]


@dataclasses.dataclass(frozen=True)
class Fixture:
    name: str
    spec: TraversalSpec
    config: StridingConfig
    rule: str                      # the rule id check() must produce
    check_kwargs: dict = dataclasses.field(default_factory=dict)


def _cache_clobber() -> Fixture:
    """4 cache slots each hold a token row, but the write map indexes
    only the embedding axis — all 4 slots (and both streams) store the
    same row; the last writer clobbers the rest."""
    spec = TraversalSpec(
        name="fixture_cache_clobber",
        axes=(Axis("slot", 4), Axis("e", 256)),
        reads=(Access("tok", ("slot", "e")),),
        writes=(Access("cache", ("e",)),),
        body=lambda env: env["tok"].float().sum(dim=-2),
        full_width=True,
    )
    return Fixture("race", spec, StridingConfig(2, 1), F.RACE001)


def _racing_redsplit() -> Fixture:
    """Per-write combinators under a stride split of the REDUCED axis:
    each of the D streams folds its own (max, sum) partials and there is
    no cross-stream merge for per-write accumulators on this path."""
    spec = TraversalSpec(
        name="fixture_racing_redsplit",
        axes=(Axis("i", 16, "reduction"), Axis("j", 256)),
        reads=(Access("x", ("i", "j")),),
        writes=(Access("mx", ("j",)), Access("sm", ("j",))),
        body=lambda env: (env["x"].float().amax(dim=0),
                          env["x"].float().sum(dim=0)),
        reduce=("max", "sum"),
        out_dtype=(torch.float32, torch.float32),
    )
    return Fixture("redsplit", spec, StridingConfig(4, 1), F.RACE003)


def _out_of_halo() -> Fixture:
    """A stencil body tapping offset +2 on an axis whose declared halo
    is (1, 1): the loaded block only includes a 1-element border, so the
    tap reads outside the padded extent."""
    halo = ((1, 1), (0, 0))
    spec = TraversalSpec(
        name="fixture_out_of_halo",
        axes=(Axis("i", 30), Axis("j", 128)),
        reads=(Access("x", ("i", "j"), halo),),
        writes=(Access("y", ("i", "j")),),
        body=lambda env: tap(env["x"], halo, 2, 0),
    )
    return Fixture("halo", spec, StridingConfig(2, 1), F.BOUNDS001)


def _smem_overflow() -> Fixture:
    """The stream copy ``y = x`` over [4096, 4096] f32 at D = 16, 8-row
    blocks and lookahead 4: a K4 ring of 4 input slots and 2 staging
    slots of 16 · 8 · 128 f32 elements at the narrowest tile, more than
    one block may opt into (``roofline.hw.H100_HW.block_smem``)."""
    spec = TraversalSpec(
        name="stream_copy",
        axes=(Axis("i", 4096), Axis("j", 4096)),
        reads=(Access("x", ("i", "j")),),
        writes=(Access("y", ("i", "j")),),
        body=lambda env: env["x"],
    )
    return Fixture("smem", spec,
                   StridingConfig(16, 1, lookahead=4, block_rows=8),
                   F.RES001)


def _reassoc() -> Fixture:
    """An interleaved arrangement splits each reduced row into P=4
    maximally-spaced lane sub-portions; folding them in that order
    reassociates the row sum.  Checked with ``assume_grouped_fold=
    False`` it is an error; the kernels fold in grouped order, so it
    reports as a warning by default."""
    spec = TraversalSpec(
        name="fixture_reassoc",
        axes=(Axis("i", 16), Axis("j", 512, "reduction")),
        reads=(Access("a", ("i", "j")), Access("x", ("j",))),
        writes=(Access("y", ("i",)),),
        body=lambda env: env["a"].float() @ env["x"].float(),
        out_dtype=torch.float32,
    )
    return Fixture(
        "reassoc", spec,
        StridingConfig(2, 4, arrangement="interleaved"), F.NUM001,
        check_kwargs={"assume_grouped_fold": False})


_BUILDERS: dict[str, Callable[[], Fixture]] = {
    "race": _cache_clobber,
    "redsplit": _racing_redsplit,
    "halo": _out_of_halo,
    "smem": _smem_overflow,
    "reassoc": _reassoc,
}

FIXTURES = tuple(_BUILDERS)


def build(name: str) -> Fixture:
    try:
        return _BUILDERS[name]()
    except KeyError:
        raise ValueError(
            f"unknown fixture {name!r} (have {', '.join(FIXTURES)})")
