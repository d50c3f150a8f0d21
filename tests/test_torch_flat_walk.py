"""The flat walk of the K1 elementwise kernels (``csrc/common.cuh``
``flat_walk``), which ``gemver_sum``, stream copy / triad / init and the
multi-tensor AdamW share, checked on the CPU through its Python mirror
(``cuda.walk_units``) and the AdamW leaf table (``adamw.kernel``).

The mirror follows the kernel's index arithmetic: the tests show that
every vector of every leaf is visited exactly once, that a step's D
streams lie in D different segments, and that the short last step and a
leaf's ragged end are masked.  The AdamW launches are then replayed
through the mirror on CPU tensors (the launcher stubbed, its arguments
decoded) against the plain version, and a list longer than one table
splits into launches of at most ``TABLE_MAX`` leaves.

    PYTHONPATH=src python -m pytest -q tests/test_torch_flat_walk.py
"""
import ctypes
import math

import pytest
import torch

from repro_torch.core.striding import StridingConfig as TConfig
from repro_torch.kernels import cuda
from repro_torch.kernels.adamw import _HYPER
from repro_torch.kernels.adamw import kernel as akernel
from repro_torch.kernels.adamw import ops as taops

# leaf shapes of mixed sizes: 1, 3, 4, 513 and 4096 elements, and a
# Mamba-2 [H] of 80
LEAVES = [(1,), (3,), (2, 2), (513,), (64, 64), (80,)]
DS = [1, 2, 4, 8]
PS = [1, 2, 4]
ARRANGEMENTS = ["grouped", "interleaved"]


def _visits(numels, itemsize, d, p, interleaved):
    """Replay the walk over the leaf table: ``(count, steps)``, each
    element's visits per leaf and, per step, the segments its units lie
    in; masked vectors are counted apart."""
    first, g = akernel.leaf_geometry(numels, itemsize, d, p)
    count = [torch.zeros(n, dtype=torch.int64) for n in numels]
    steps, masked = {}, 0
    for c, j, k, at0, live in cuda.walk_units(g, interleaved):
        steps.setdefault(c, []).append(k)
        masked += cuda.WALK_UNIT - live
        for at in range(at0, at0 + live):
            unit = at // cuda.WALK_UNIT
            if unit >= first[-1]:
                masked += 1
                continue
            leaf = akernel.leaf_of(first, unit)
            e0 = (at - first[leaf] * cuda.WALK_UNIT) * g.vec
            if e0 >= numels[leaf]:
                masked += 1
                continue
            count[leaf][e0:min(e0 + g.vec, numels[leaf])] += 1
    return first, g, count, steps, masked


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "16bit"])
@pytest.mark.parametrize("arr", ARRANGEMENTS)
@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("d", DS)
def test_walk_visits_every_element_of_every_leaf_once(d, p, arr, itemsize):
    numels = [math.prod(s) for s in LEAVES]
    first, g, count, steps, masked = _visits(numels, itemsize, d, p,
                                             arr == "interleaved")
    for n, c in zip(numels, count):
        assert bool((c == 1).all()), (n, c.unique())
    # every leaf starts on a whole unit; the segments are whole units
    assert first[0] == 0 and g.segv % cuda.WALK_UNIT == 0
    assert g.segv * d >= first[-1] * cuda.WALK_UNIT
    # a step's D x P units: P in each of the D segments
    for ks in steps.values():
        assert sorted(ks) == sorted(list(range(d)) * p)
    # everything the grid covers past the leaves' elements is masked
    covered = g.steps * g.units * cuda.WALK_UNIT * d
    assert covered - masked == sum(-(-n // g.vec) for n in numels)
    assert g.held == akernel.HELD == 2


@pytest.mark.parametrize("arr", ARRANGEMENTS)
@pytest.mark.parametrize("d,p", [(1, 1), (2, 2), (4, 1), (8, 4)])
def test_short_last_step_and_ragged_ends_are_masked(d, p, arr):
    """A leaf of 513 f32 elements is 129 vectors (one element in the
    last): two units, the second with one live vector of one element;
    the last step of a segment stops at the segment's end."""
    numels = [513]
    first, g, count, _, _ = _visits(numels, 4, d, p, arr == "interleaved")
    assert first == [0, 2]
    assert bool((count[0] == 1).all())
    lives = [live for *_, live in cuda.walk_units(g, arr == "interleaved")]
    assert max(lives) == cuda.WALK_UNIT
    # the segments are whole units: a unit is wholly live or wholly past
    assert set(lives) <= {0, cuda.WALK_UNIT}
    # a walk whose segment is not a whole number of steps masks the rest
    short = cuda.walk_geometry(200, d, p, 4)
    per_seg = {}
    for c, j, k, at0, live in cuda.walk_units(short, arr == "interleaved"):
        per_seg[k] = per_seg.get(k, 0) + live
        assert 0 <= live <= cuda.WALK_UNIT
    assert per_seg == {k: 200 for k in range(d)}


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("d", DS)
def test_grouped_block_j_runs_stream_j(d, p, itemsize):
    """Grouped: block j of a step runs P units of stream j.  Interleaved:
    the step's D·P units, unit j·P + s of block j, go to the streams
    round-robin, stream (j·P + s) mod D, at offset (j·P + s) div D."""
    g = cuda.walk_geometry(3 * p * cuda.WALK_UNIT + 5, d, p, itemsize)
    for c, j, k, at0, live in cuda.walk_units(g, False):
        assert k == j and (not live or at0 // g.segv == k)
    blocks = {}
    for c, j, k, at0, live in cuda.walk_units(g, True):
        blocks.setdefault((c, j), []).append((k, at0 - k * g.segv))
        assert not live or at0 // g.segv == k
    for (c, j), units in blocks.items():
        assert units == [((j * p + s) % d,
                          (c * p + (j * p + s) // d) * cuda.WALK_UNIT)
                         for s in range(p)]
    assert g.passes == -(-p // cuda.WALK_HELD)


def test_leaf_table_by_hand():
    """Units of 128 16-byte vectors: 1, 3 and 4 f32 elements take one
    vector and one unit each; 513 take 129 vectors, two units; 4096 take
    1024 vectors, eight units; 80 take 20 vectors, one unit.  In bf16 a
    vector is 8 elements."""
    numels = [math.prod(s) for s in LEAVES]
    assert akernel.leaf_first(numels, 4) == [0, 1, 2, 3, 5, 13, 14]
    assert akernel.leaf_first(numels, 8) == [0, 1, 2, 3, 4, 8, 9]
    first = akernel.leaf_first(numels, 4)
    assert [akernel.leaf_of(first, u) for u in range(14)] == \
        [0, 1, 2, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4, 5]
    first, g = akernel.leaf_geometry(numels, 4, 4, 2)
    assert (g.segv, g.d, g.units, g.steps, g.vec) == (512, 4, 2, 2, 4)


# ------------------------------------------- AdamW launches, replayed

def _leaves(gen, shapes, pdt=torch.float32, gdt=None):
    out = []
    for s in shapes:
        p = torch.randn(*s, generator=gen).to(pdt)
        g = torch.randn(*s, generator=gen).to(gdt or pdt)
        m = torch.randn(*s, generator=gen)
        v = torch.rand(*s, generator=gen)
        out.append((p, g, m, v))
    return [list(x) for x in zip(*out)]


class _Replay:
    """Stands in for the ADAMW launcher on CPU tensors: decodes each
    launch's arguments and runs the walk's mirror over them, applying
    the plain body to each visited vector's elements once."""

    def __init__(self, tensors):
        self.by_ptr = {t.data_ptr(): t for t in tensors}
        self.launches = []

    def __call__(self, device, dtype, gdtype, n, ptrs, ns, wds, first, s,
                 gscale, po, mo, vo, segv, d, np_, interleaved):
        ptrs = [self.by_ptr[x] for x in ptrs]
        leaves = [ptrs[4 * i:4 * i + 4] for i in range(n)]
        first = list(first)
        self.launches.append((n, first[-1], segv, d, np_))
        sc = list(self._scalars[s].unbind())
        itemsize = leaves[0][0].element_size()
        g = cuda.walk_geometry(segv, d, np_, itemsize)
        vec = g.vec
        for _, _, _, at0, live in cuda.walk_units(g, bool(interleaved)):
            for at in range(at0, at0 + live):
                unit = at // cuda.WALK_UNIT
                if unit >= first[-1]:
                    continue
                i = akernel.leaf_of(first, unit)
                p, gr, m, v = (t.view(-1) for t in leaves[i])
                e0 = (at - first[i] * cuda.WALK_UNIT) * vec
                if e0 >= ns[i]:
                    continue
                sl = slice(e0, min(e0 + vec, ns[i]))
                gg = gr[sl].float()
                if gscale is not None:
                    gg = gg * self._scalars[gscale]
                w = sc[:4] + [torch.tensor(wds[i] if wds else float(sc[4]),
                                           dtype=torch.float32)] + sc[5:]
                pn, mn, vn = taops._plain(p[sl], gg, m[sl], v[sl], w)
                p[sl], m[sl], v[sl] = pn, mn, vn


def _replay(monkeypatch, tensors, s7, gscale):
    rep = _Replay(tensors)
    rep._scalars = {s7.data_ptr(): s7}
    if gscale is not None:
        rep._scalars[gscale.data_ptr()] = gscale
    monkeypatch.setattr(akernel, "ADAMW", rep)
    return rep


@pytest.mark.parametrize("pdt,gdt", [(torch.float32, None),
                                     (torch.bfloat16, None),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float16, torch.float32)])
@pytest.mark.parametrize("arr", ARRANGEMENTS)
@pytest.mark.parametrize("d,p", [(1, 1), (2, 2), (4, 1), (8, 4)])
@pytest.mark.parametrize("scaled", [False, True])
def test_replayed_launch_equals_the_plain_version(monkeypatch, pdt, gdt, arr,
                                                  d, p, scaled):
    gen = torch.Generator().manual_seed(d * 10 + p)
    ps, gs, ms, vs = _leaves(gen, LEAVES, pdt, gdt)
    want = [[t.clone() for t in x] for x in (ps, gs, ms, vs)]
    wds = [0.1 if len(s) > 1 else 0.0 for s in LEAVES]
    s7 = torch.tensor(list(_HYPER.values()), dtype=torch.float32)
    gscale = torch.tensor(0.37) if scaled else None
    rep = _replay(monkeypatch, ps + gs + ms + vs, s7, gscale)
    akernel.update_leaves(ps, gs, ms, vs, wds, s7, gscale,
                          TConfig(d, p, arrangement=arr))
    taops.adamw_update_many(*want, wds, s7, gscale=gscale, mode="ref")
    assert len(rep.launches) == 1
    for got, ref in zip(ps + ms + vs, want[0] + want[2] + want[3]):
        assert torch.equal(got, ref)


def test_a_list_longer_than_one_table_splits(monkeypatch):
    """1100 leaves: launches of 512, 512 and 76, each over its own
    table, and every leaf updated as the plain version updates it."""
    gen = torch.Generator().manual_seed(3)
    shapes = [((i % 7) + 1,) for i in range(1100)]
    ps, gs, ms, vs = _leaves(gen, shapes)
    want = [[t.clone() for t in x] for x in (ps, gs, ms, vs)]
    s7 = torch.tensor(list(_HYPER.values()), dtype=torch.float32)
    rep = _replay(monkeypatch, ps + gs + ms + vs, s7, None)
    akernel.update_leaves(ps, gs, ms, vs, None, s7, None, TConfig(2, 2))
    taops.adamw_update_many(*want, None, s7, mode="ref")
    assert [n for n, *_ in rep.launches] == [512, 512, 76]
    assert akernel.TABLE_MAX == 512
    for got, ref in zip(ps + ms + vs, want[0] + want[2] + want[3]):
        assert torch.equal(got, ref)


def test_leaves_the_kernel_refuses():
    gen = torch.Generator().manual_seed(1)
    ps, gs, ms, vs = _leaves(gen, [(64, 64), (80,)])
    akernel.check_leaves("adamw_update", ps, gs, ms, vs)
    with pytest.raises(ValueError, match="contiguous"):
        akernel.check_leaves("adamw_update", [ps[0].t()], gs[:1], ms[:1],
                             vs[:1])
    off = torch.zeros(81)[1:]                  # 4 bytes past an allocation
    with pytest.raises(ValueError, match="16-byte aligned"):
        akernel.check_leaves("adamw_update", [off], [gs[1]], [ms[1]],
                             [vs[1]])
    with pytest.raises(TypeError):              # g neither p's type nor f32
        akernel.check_leaves("adamw_update", [ps[1].bfloat16()],
                             [gs[1].half()], [ms[1]], [vs[1]])
    with pytest.raises(TypeError):              # m not f32
        akernel.check_leaves("adamw_update", ps[1:], gs[1:],
                             [ms[1].double()], vs[1:])
    with pytest.raises(ValueError, match="elements"):
        akernel.check_leaves("adamw_update", ps[1:], [gs[0]], ms[1:], vs[1:])
    with pytest.raises(ValueError, match="gscale"):
        akernel.update_leaves(ps, gs, ms, vs, None, torch.zeros(7),
                              torch.ones(2), TConfig(2, 2))


def test_launch_arguments_are_one_table(monkeypatch):
    """The launcher's arguments: p, g, m, v pointers of each leaf in
    order, the element counts, the weight decays as f32, the first
    units, the segment length and the config's D and P."""
    gen = torch.Generator().manual_seed(2)
    ps, gs, ms, vs = _leaves(gen, LEAVES)
    seen = []
    monkeypatch.setattr(akernel, "ADAMW", lambda *a: seen.append(a))
    s7 = torch.zeros(7)
    akernel.update_leaves(ps, gs, ms, vs, [0.1] * 6, s7, None,
                          TConfig(4, 2, arrangement="interleaved"))
    (a,) = seen
    (dev, dt, gdt, n, ptrs, ns, wds, first, s, gsc, po, mo, vo, segv, d,
     np_, inter) = a
    assert (dt, gdt, n, d, np_, inter) == (0, 0, 6, 4, 2, 1)
    assert list(ptrs) == [t.data_ptr() for leaf in zip(ps, gs, ms, vs)
                          for t in leaf]
    assert list(ns) == [math.prod(s) for s in LEAVES]
    assert list(wds) == [ctypes.c_float(0.1).value] * 6
    assert list(first) == [0, 1, 2, 3, 5, 13, 14] and segv == 512
    assert s == s7.data_ptr() and gsc is None and po is None
