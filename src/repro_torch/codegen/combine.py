"""Reduction combine algebra for stride-axis reductions, in torch.

A :class:`Combine` is a monoid over a *tuple* of f32 accumulators: a
stride-axis reduction folds every stream's (and every row step's)
partial state in with :meth:`Combine.merge`, and applies
:meth:`Combine.finalize` once at the end of the sweep to turn the
accumulated state into the written output.  ``sum`` and ``max`` are the
degenerate single-state instances (finalize is the identity);
:class:`OnlineSoftmax` is the paired-state instance flash-decode needs —
a running max plus a max-rescaled weighted sum, merged with the
online-softmax rescaling identity:

    m  = max(m1, m2)
    n  = n1 * exp(m1 - m) + n2 * exp(m2 - m)
    d  = d1 * exp(m1 - m) + d2 * exp(m2 - m)

which is associative and has (m=NEG_INF, n=0, d=0) as its identity.

``NEG_INF`` is the *finite* ``-1e30``, never ``-inf``: a segment whose
rows are all masked carries the state ``(-1e30, ΣV, rows)`` and merges
away with weight ``exp(-1e30 - m) == 0`` against any real state, while
two empty states merge to ``exp(0) == 1`` weights instead of the
``exp(-inf - -inf) = NaN`` a true infinity would give.  The CUDA
decode kernel (``csrc/decode_attn.cu``) keeps the same constant.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

__all__ = ["Combine", "SumCombine", "MaxCombine", "OnlineSoftmax",
           "SUM", "MAX", "resolve_combine", "NEG_INF"]

NEG_INF = -1e30   # finite -inf stand-in: exp(NEG_INF - m) underflows to 0


class Combine:
    """Paired-state reduction combinator (init / merge / finalize).

    ``finalizing`` declares that :meth:`finalize` maps the accumulated
    state to the *written* block(s) — the body then returns partial
    STATE, and ``finalize`` may emit one block per spec write (e.g.
    ``OnlineSoftmax(with_lse=True)`` finalizes ``(attention, lse)``).
    """

    name: str = "combine"
    n_state: int = 1
    finalizing: bool = False

    def init(self, shapes: Sequence[tuple[int, ...]], device=None) -> tuple:
        """Identity state: one f32 tensor per component shape."""
        raise NotImplementedError

    def merge(self, state: tuple, part: tuple) -> tuple:
        """Fold one partial state into the accumulated state."""
        raise NotImplementedError

    def finalize(self, state: tuple):
        """Accumulated state → output block."""
        raise NotImplementedError


class SumCombine(Combine):
    name = "sum"

    def init(self, shapes, device=None):
        return (torch.zeros(shapes[0], dtype=torch.float32, device=device),)

    def merge(self, state, part):
        return (state[0] + part[0],)

    def finalize(self, state):
        return state[0]


class MaxCombine(Combine):
    name = "max"

    def init(self, shapes, device=None):
        return (torch.full(shapes[0], NEG_INF, dtype=torch.float32,
                           device=device),)

    def merge(self, state, part):
        return (torch.maximum(state[0], part[0]),)

    def finalize(self, state):
        return state[0]


@dataclasses.dataclass(frozen=True)
class OnlineSoftmax(Combine):
    """Numerically-stable streaming softmax-weighted average.

    State is ``(m, num, den)`` per softmax group: running score max,
    max-rescaled weighted value sum (``groups * vwidth`` lanes wide) and
    max-rescaled weight sum.  ``finalize`` divides, so a spec reduced
    with this combinator writes ``softmax(scores) @ V`` in ONE sweep of
    the streamed operands.

    ``with_lse=True`` makes ``finalize`` ALSO emit the per-group
    log-sum-exp ``m + log(max(den, eps))`` as a second output block.
    """

    groups: int            # independent softmax rows in the output
    vwidth: int            # value lanes per group (num width = g * v)
    eps: float = 1e-20     # finalize denominator floor
    with_lse: bool = False   # finalize emits (out, logsumexp) pairs
    name: str = dataclasses.field(default="online_softmax", repr=False)
    n_state: int = dataclasses.field(default=3, repr=False)
    finalizing: bool = dataclasses.field(default=True, repr=False)

    def init(self, shapes, device=None):
        m_shape, num_shape, den_shape = shapes
        return (torch.full(m_shape, NEG_INF, dtype=torch.float32,
                           device=device),
                torch.zeros(num_shape, dtype=torch.float32, device=device),
                torch.zeros(den_shape, dtype=torch.float32, device=device))

    def _rescale(self, num, alpha):
        shape = num.shape
        num = num.reshape(shape[:-1] + (self.groups, self.vwidth))
        return (num * alpha[..., None]).reshape(shape)

    def merge(self, state, part):
        m1, n1, d1 = state
        m2, n2, d2 = part
        m = torch.maximum(m1, m2)
        a1 = torch.exp(m1 - m)
        a2 = torch.exp(m2 - m)
        return (m,
                self._rescale(n1, a1) + self._rescale(n2, a2),
                d1 * a1 + d2 * a2)

    def finalize(self, state):
        m, num, den = state
        shape = num.shape
        num = num.reshape(shape[:-1] + (self.groups, self.vwidth))
        den = torch.clamp_min(den, self.eps)
        out = (num / den[..., None]).reshape(shape)
        if not self.with_lse:
            return out
        return out, m + torch.log(den)


SUM = SumCombine()
MAX = MaxCombine()


def resolve_combine(reduce) -> Combine:
    """Spec ``reduce`` field → combinator ("sum" | "max" | instance)."""
    if isinstance(reduce, Combine):
        return reduce
    if reduce == "sum":
        return SUM
    if reduce == "max":
        return MAX
    raise ValueError(f"unknown reduce {reduce!r} (expected 'sum', 'max', "
                     "or a codegen.Combine instance)")
