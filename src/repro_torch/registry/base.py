"""Declarative kernel registry.

Every kernel family under ``repro_torch.kernels`` registers one
:class:`KernelSpec` per public variant: a uniform adapter around the op,
its plain PyTorch oracle, its Traffic signature and its default, aliased
and benchmark problem sizes.  The ``repro_torch.kernels`` export table,
the conformance matrix and ``chip_smoke.py``'s registry phase derive
from it, as in the JAX package (``src/repro/registry/base.py``), whose
rows these mirror name for name, size for size and tolerance for
tolerance.

Adapter conventions (uniform across variants so harnesses can iterate):

  * ``make_inputs(sizes, dtype, device) -> tuple`` — deterministic
    example inputs, drawn with numpy from a fixed seed per operand
    (``kernels.common.example_input``) and made on ``device``;
  * ``run(inputs, config, mode) -> outputs`` — invoke the variant: the
    hand kernels for inputs on the card, the plain versions on the CPU
    or with ``mode="ref"``;
  * ``ref(inputs, config) -> outputs`` — oracle (config is passed because
    a few kernels, e.g. ``stream_read``, have config-dependent *shapes*);
  * ``traffic(sizes, dtype) -> Traffic | None`` — planner signature;
  * ``cache_shape(sizes) -> tuple`` — the shape key the op resolves its
    config under;
  * ``traversal(sizes, dtype) -> TraversalSpec | tuple`` — the codegen
    IR the variant lowers, built on ``device="meta"`` tensors (no data).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Mapping, Optional, Sequence

from repro_torch.core.striding import SINGLE_STRIDED, StridingConfig

__all__ = ["KernelSpec", "register", "get", "names", "families",
           "all_specs", "family_specs", "registered_ops", "FAMILIES",
           "CONFORMANCE_CONFIGS", "conformance_points"]


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One registered kernel variant (paper Table 1 row)."""

    name: str                      # unique public name, e.g. "stream_read"
    family: str                    # kernel package, e.g. "stream"
    fn: Callable                   # the public op (exported callable)
    make_inputs: Callable[[Mapping[str, int], Any, Any], tuple]
    run: Callable[[tuple, Optional[StridingConfig], Optional[str]], Any]
    ref: Callable[[tuple, StridingConfig], Any]
    default_sizes: Mapping[str, int]
    aliased_sizes: Mapping[str, int]   # §4.5 power-of-two-spacing point
    traffic: Optional[Callable[[Mapping[str, int], Any], Any]] = None
    cache_shape: Optional[Callable[[Mapping[str, int]], tuple]] = None
    traversal: Optional[Callable[[Mapping[str, int], Any], Any]] = None
    bench_sizes: Optional[Mapping[str, int]] = None  # benchmark-scale problem
    rtol: float = 1e-4
    atol: float = 1e-4
    tags: tuple[str, ...] = ()     # ("paper",) / ("framework",) / ("gen",)

    def __post_init__(self):
        if not self.name.isidentifier():
            raise ValueError(f"spec name {self.name!r} is not exportable")

    @property
    def bench_problem(self) -> dict:
        return dict(self.bench_sizes if self.bench_sizes is not None
                    else self.default_sizes)


_REGISTRY: dict[str, KernelSpec] = {}

# The kernel families the registry discovers on first use: a family's
# package registers its rows when it is imported.
FAMILIES = ("stream", "mxv", "bicg", "gemver", "conv3x3", "jacobi2d",
            "doitgen", "decode_attn", "rmsnorm", "adamw", "gen")


def register(spec: KernelSpec) -> KernelSpec:
    """Add a variant to the registry (idempotent per name+family)."""
    prev = _REGISTRY.get(spec.name)
    if prev is not None and prev.family != spec.family:
        raise ValueError(
            f"kernel name {spec.name!r} already registered by family "
            f"{prev.family!r}")
    _REGISTRY[spec.name] = spec
    return spec


def _ensure_loaded() -> None:
    for fam in FAMILIES:
        importlib.import_module(f"repro_torch.kernels.{fam}")


def get(name: str) -> KernelSpec:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown kernel {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def names() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def families() -> list[str]:
    _ensure_loaded()
    return sorted({s.family for s in _REGISTRY.values()})


def all_specs() -> list[KernelSpec]:
    _ensure_loaded()
    return [_REGISTRY[n] for n in sorted(_REGISTRY)]


def family_specs(family: str) -> list[KernelSpec]:
    return [s for s in all_specs() if s.family == family]


def registered_ops() -> dict[str, Callable]:
    """{public name: op callable} — the ``repro_torch.kernels`` export
    table.  Does NOT trigger discovery: ``repro_torch.kernels`` calls it
    after importing the family packages, and discovering from there
    would re-enter the package's import."""
    return {s.name: s.fn for s in _REGISTRY.values()}


# --------------------------------------------------------------- matrix
# The conformance matrix: every registered kernel at these (D, P) points
# against its oracle.  SINGLE_STRIDED is the paper's baseline; the
# "aliased" point re-runs (4, 1) on sizes whose inter-stream spacing is
# an exact power of two (§4.5).
CONFORMANCE_CONFIGS: Sequence[tuple[str, StridingConfig]] = (
    ("single", SINGLE_STRIDED),
    ("d2p1", StridingConfig(2, 1)),
    ("d2p2", StridingConfig(2, 2)),
    ("d4p1", StridingConfig(4, 1)),
    ("d4p2", StridingConfig(4, 2)),
)


def conformance_points() -> list[tuple[str, str, dict, StridingConfig]]:
    """[(point_id, kernel, sizes, config)] for the whole registry."""
    pts = []
    for spec in all_specs():
        for label, cfg in CONFORMANCE_CONFIGS:
            pts.append((f"{spec.name}-{label}", spec.name,
                        dict(spec.default_sizes), cfg))
        pts.append((f"{spec.name}-aliased", spec.name,
                    dict(spec.aliased_sizes), StridingConfig(4, 1)))
    return pts
