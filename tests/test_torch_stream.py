"""The port's stream family and K4 ring against the JAX package.

Inputs are drawn with numpy from a seed and the same arrays go to both
packages.  The ops are held against the JAX ops in ``mode="ref"`` at the
six conformance points (the five ``CONFORMANCE_CONFIGS`` at the
registry's ``default_sizes``, D=4 at its ``aliased_sizes``) and at a
ragged shape under each config (42 rows clamp D=4 to 3; 200 columns pad
to 256).  The kernel structure is held against the JAX emitter in
interpret mode: the port's emitter front end on CPU tensors runs each
kernel wrapper's plain version (the read's two passes over column
chunks, the K4 ring's spec body) and must agree with the Pallas kernels
and plan the same blocks; at a ``lookahead`` other than 2 both packages
must take K4 (``_emit_manual``).  Tolerances are the registry rows'
``rtol``/``atol`` of 1e-4, and equality where the body is a copy or a
fill.  The CUDA kernels themselves are tested on the card in
``test_torch_cuda.py``.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import codegen as jcg
from repro.codegen import emit as jemit
from repro.codegen import transforms as jtransforms
from repro.core.striding import StridingConfig as JConfig
from repro.kernels.gemver import specs as jgspecs
from repro.kernels.stream import ops as jsops
from repro.kernels.stream import ref as jsref
from repro.kernels.stream import specs as jsspecs
from repro.registry import base as jreg
from repro_torch import codegen as tcg
from repro_torch.codegen import transforms as ttransforms
from repro_torch.core.striding import StridingConfig as TConfig
from repro_torch.kernels import cuda
from repro_torch.kernels import manual as tmanual
from repro_torch.kernels.gemver import specs as tgspecs
from repro_torch.kernels.stream import _ALIASED, _BENCH, _SIZES
from repro_torch.kernels.stream import kernel as skernel
from repro_torch.kernels.stream import ops as tsops
from repro_torch.kernels.stream import ref as tsref
from repro_torch.kernels.stream import specs as tsspecs

CONFIGS = list(jreg.CONFORMANCE_CONFIGS)
RAGGED = {"rows": 42, "cols": 200}
POINTS = ([(label, cfg, "default") for label, cfg in CONFIGS]
          + [("aliased", JConfig(4, 1), "aliased")]
          + [(f"ragged-{label}", cfg, "ragged") for label, cfg in CONFIGS])
ALPHA = 1.5
FILL = 3.5
TOL = {"rtol": 1e-4, "atol": 1e-4}      # the stream registry rows'


def _tcfg(c: JConfig) -> TConfig:
    return TConfig(c.stride_unroll, c.portion_unroll, c.lookahead,
                   c.arrangement, c.block_rows)


def _sizes(which: str) -> tuple[int, int]:
    s = {"default": _SIZES, "aliased": _ALIASED, "ragged": RAGGED}[which]
    return s["rows"], s["cols"]


def _arrays(shape, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _j(args):
    return [jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for a in args]


def _t(args):
    return [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in args]


def _close(got, want, exact: bool):
    assert tuple(got.shape) == tuple(want.shape)
    if exact:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_registry_sizes_are_the_jax_packages():
    for name in ("stream_read", "stream_copy", "stream_init",
                 "stream_copy_manual"):
        row = jreg.get(name)
        assert row.default_sizes == _SIZES
        assert row.aliased_sizes == _ALIASED
        assert row.bench_sizes == _BENCH
        assert (row.rtol, row.atol) == (TOL["rtol"], TOL["atol"])


# ----------------------------------------------------------- ops vs ref

def _op_case(name: str, which: str, cfg: JConfig):
    """(JAX call, port call, exact?) of one op on numpy inputs."""
    shape = _sizes(which)
    (x,) = _arrays(shape, 1, seed=1)
    tc = _tcfg(cfg)
    if name == "stream_init":
        return (lambda: jsops.stream_init(shape, FILL, jnp.float32,
                                          config=cfg, mode="ref"),
                lambda: tsops.stream_init(shape, FILL, torch.float32,
                                          config=tc, device="cpu"), True)
    jop, top = getattr(jsops, name), getattr(tsops, name)
    return (lambda: jop(jnp.asarray(x), config=cfg, mode="ref"),
            lambda: top(torch.from_numpy(x), config=tc),
            name != "stream_read")


@pytest.mark.parametrize("name", ["stream_read", "stream_copy",
                                  "stream_init", "stream_copy_manual"])
@pytest.mark.parametrize("label,cfg,which", POINTS,
                         ids=[p[0] for p in POINTS])
def test_op_matches_jax_ref(name, label, cfg, which):
    """The port's op on CPU tensors against the JAX op in ref mode, with
    the same explicit config on both sides; ``stream_read``'s ``[D]``
    output follows the clamped config (D=3 at 42 rows under D=4)."""
    jcall, tcall, exact = _op_case(name, which, cfg)
    _close(tcall(), jcall(), exact)


@pytest.mark.parametrize("label,cfg,which", POINTS,
                         ids=[p[0] for p in POINTS])
def test_triad_matches_jax_ref(label, cfg, which):
    """triad has no op of its own in the stream family (the JAX package's
    lives in ``kernels/gen``): its spec through both ``run_spec``s."""
    b, c = _arrays(_sizes(which), 2, seed=2)
    want = jcg.run_spec(jsspecs.triad_spec, _j([b, c, ALPHA]), cfg, "ref")
    got = tcg.run_spec(tsspecs.triad_spec, _t([b, c, ALPHA]), _tcfg(cfg))
    _close(got, want, exact=False)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("arrangement", ["grouped", "interleaved"])
@pytest.mark.parametrize("d,p", [(16, 2), (4, 3)])
@pytest.mark.parametrize("name", ["stream_copy", "stream_triad",
                                  "stream_init"])
def test_16bit_k1_bodies_match_jax_ref(name, d, p, arrangement, dtype):
    """copy, triad and init in bf16 and f16 at the shapes the 16-bit
    lanes of ``csrc/stream.cu`` treat apart (384 columns: a step ends on
    an odd sub-portion; D=16: two groups of 8 streams; P=3: a pair
    starting on an odd sub-portion), both arrangements: the port's op on
    CPU tensors equals the JAX op in ref mode, bit for bit (each
    operation rounded to the dtype on both sides)."""
    shape = (64, 384)
    cfg = JConfig(d, p, arrangement=arrangement)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    b, c = (np.array(jnp.asarray(x, jdt).astype(jnp.float32))
            for x in _arrays(shape, 2, seed=d + p))
    if name == "stream_init":
        want = jsops.stream_init(shape, FILL, jdt, config=cfg, mode="ref")
        got = tsops.stream_init(shape, FILL, tdt, config=_tcfg(cfg),
                                device="cpu")
    elif name == "stream_copy":
        want = jsops.stream_copy(jnp.asarray(b, jdt), config=cfg, mode="ref")
        got = tsops.stream_copy(torch.from_numpy(b).to(tdt),
                                config=_tcfg(cfg))
    else:
        want = jcg.run_spec(jsspecs.triad_spec,
                            [jnp.asarray(b, jdt), jnp.asarray(c, jdt),
                             ALPHA], cfg, "ref")
        got = tcg.run_spec(tsspecs.triad_spec,
                           [torch.from_numpy(b).to(tdt),
                            torch.from_numpy(c).to(tdt), ALPHA],
                           _tcfg(cfg))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_stream_read_output_follows_the_resolved_d():
    x = torch.from_numpy(_arrays((42, 200), 1, seed=3)[0])
    assert tsops.stream_read(x).shape == (3,)          # default D=4 → 3
    assert tsops.stream_read(x, config=TConfig(7, 1)).shape == (7,)
    assert tsops.stream_read(x, config=TConfig(1, 1)).shape == (1,)


# ------------------------------------------------- kernel structure

def _plans(monkeypatch):
    """Record every BlockPlan either package's emitter plans."""
    seen = {"jax": [], "port": []}

    def spy(mod, key):
        real = mod.plan_blocks

        def plan(spec, config, *a, **kw):
            bp = real(spec, config, *a, **kw)
            seen[key].append((spec.name, bp.d, bp.bm, bp.bn, bp.rows,
                              bp.cols, dataclasses.asdict(bp.info)))
            return bp
        monkeypatch.setattr(mod, "plan_blocks", plan)
    spy(jtransforms, "jax")
    spy(ttransforms, "port")
    return seen


def _spec_case(name: str, which: str, seed: int, d: int = 4):
    """(JAX spec factory, port spec factory, numpy inputs, exact?) of one
    spec of the slice; the read's input is already ``[D, seg·cols]``."""
    rows, cols = _sizes(which)
    if name == "stream_copy":
        return jsspecs.copy_spec, tsspecs.copy_spec, _arrays(
            (rows, cols), 1, seed), True
    if name == "stream_triad":
        # XLA may contract b + alpha * c into one fused multiply-add
        return jsspecs.triad_spec, tsspecs.triad_spec, _arrays(
            (rows, cols), 2, seed) + [ALPHA], False
    if name == "stream_init":
        return (functools.partial(jsspecs.init_spec, (rows, cols),
                                  jnp.float32),
                functools.partial(tsspecs.init_spec, (rows, cols),
                                  torch.float32), [FILL], True)
    if name == "stream_read":
        (x,) = _arrays((rows, cols), 1, seed)
        return (jsspecs.read_spec, tsspecs.read_spec,
                [x.reshape(d, rows // d * cols)], False)
    assert name == "gemver_sum"
    n = {"default": 1000, "aliased": 2048, "ragged": 777}[which]
    return (jgspecs.gemver_sum_spec, tgspecs.gemver_sum_spec,
            _arrays((n,), 2, seed), True)


def _port_emit(spec, args, cfg):
    """The port's emitter front end on CPU tensors: plan, pad, the kernel
    wrapper's plain version (per pass), crop; no launch."""
    before = {n: k.launches for n, k in cuda.KERNELS.items()}
    out = tcg.emit_spec(spec, args, cfg, device="cpu")
    assert all(k.launches == before.get(n, 0)
               for n, k in cuda.KERNELS.items())
    return out


@pytest.mark.parametrize("name", ["stream_copy", "stream_triad",
                                  "stream_init", "stream_read"])
@pytest.mark.parametrize("label,cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_kernel_structure_matches_jax_interpret(monkeypatch, name, label,
                                                cfg):
    """Each spec of the slice through both emitters at the registry's
    default sizes: the JAX Pallas kernel (K1, or K2 for the read) in
    interpret mode against the port's front end and kernel wrapper, with
    equal block plans."""
    jb, tb, args, exact = _spec_case(name, "default", seed=7,
                                     d=cfg.stride_unroll)
    seen = _plans(monkeypatch)
    want = jcg.emit_spec(jb(*_j(args)), _j(args), cfg, interpret=True)
    got = _port_emit(tb(*_t(args)), _t(args), _tcfg(cfg))
    _close(got, want, exact)
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 1


K4_CASES = ([(n, "default") for n in ("stream_copy", "stream_triad",
                                      "stream_init", "gemver_sum")]
            + [(n, "ragged") for n in ("stream_copy", "stream_triad")])


@pytest.mark.parametrize("lookahead", [1, 3, 4])
@pytest.mark.parametrize("name,which", K4_CASES,
                         ids=[f"{n}-{w}" for n, w in K4_CASES])
def test_k4_ring_matches_jax_emit_manual(monkeypatch, name, which,
                                         lookahead):
    """At a lookahead other than 2 both packages run the K4 template: the
    JAX ``_emit_manual`` in interpret mode against the port's ring
    (``kernels/manual.py``, its plain version on CPU tensors), with equal
    block plans: bit for bit for copy, fill and the sum, within the
    registry tolerance for triad.  ``stream_copy`` is
    ``stream_copy_manual``'s spec."""
    jb, tb, args, exact = _spec_case(name, which, seed=11)
    cfg = JConfig(4, 2, lookahead=lookahead)
    seen = _plans(monkeypatch)
    ran = []
    for mod, key in ((jemit, "_emit_manual"), (tmanual, "emit")):
        real = getattr(mod, key)

        def spy(*a, _real=real, _key=key, **kw):
            ran.append(_key)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, key, spy)
    want = jcg.emit_spec(jb(*_j(args)), _j(args), cfg, interpret=True)
    got = _port_emit(tb(*_t(args)), _t(args), _tcfg(cfg))
    _close(got, want, exact)
    assert ran == ["_emit_manual", "emit"]
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 1


class _Chosen(Exception):
    pass


def _jax_template(spec, args, cfg) -> str:
    """The template the JAX emitter picks for ``spec`` (its own
    ``emit_scheduled`` rule; the chosen lowering is stopped before it
    builds anything)."""
    names = {"_emit_streaming": "K1", "_emit_reduction": "K2",
             "_emit_stream_reduction": "K3", "_emit_manual": "K4"}
    saved = {n: getattr(jemit, n) for n in names}

    def stop(t):
        def fn(*a, **kw):
            raise _Chosen(t)
        return fn
    try:
        for n, t in names.items():
            setattr(jemit, n, stop(t))
        jcg.emit_spec(spec, args, cfg, interpret=True)
    except _Chosen as chosen:
        return chosen.args[0]
    finally:
        for n, fn in saved.items():
            setattr(jemit, n, fn)
    raise AssertionError("the JAX emitter chose no template")


SLICE_SPECS = ("stream_copy", "stream_triad", "stream_init", "stream_read",
               "gemver_sum")


@pytest.mark.parametrize("name", SLICE_SPECS)
@pytest.mark.parametrize("lookahead", [1, 2, 3])
@pytest.mark.parametrize("label,cfg,which", POINTS,
                         ids=[p[0] for p in POINTS])
def test_block_plans_and_templates_match_jax(monkeypatch, name, lookahead,
                                             label, cfg, which):
    """Every spec of the slice: equal classification and block plan
    (for ``gemver_sum`` the plan of its §5.1.1 tiling, the port's
    ``block_1d`` against the plan the JAX ``_emit_blocked`` makes), and
    the template the JAX emitter picks, at every conformance point, the
    ragged shape and three lookaheads.  The read runs under the D its
    wrapper resolves (clamped to divide the rows)."""
    cfg = dataclasses.replace(cfg, lookahead=lookahead)
    if name == "stream_read":
        rows = _sizes(which)[0]
        cfg = dataclasses.replace(cfg, stride_unroll=max(
            k for k in range(1, cfg.stride_unroll + 1) if rows % k == 0))
    jb, tb, args, _ = _spec_case(name, which, seed=0, d=cfg.stride_unroll)
    jspec, tspec = jb(*_j(args)), tb(*_t(args))
    tcfg = _tcfg(cfg)
    assert (dataclasses.asdict(tcg.classify(tspec))
            == dataclasses.asdict(jcg.classify(jspec)))
    seen = _plans(monkeypatch)
    assert tcg.template_of(tspec, tcfg) == _jax_template(jspec, _j(args),
                                                        cfg)
    if tcg.classify(tspec).blocked:
        tspec, n = tcg.block_1d(tspec, tcfg)
        assert n == args[0].shape[0]
    ttransforms.plan_blocks(tspec, tcfg)
    assert seen["port"] == seen["jax"] and len(seen["jax"]) == 1


# ------------------------------------------------ the K4 tiling rule

SMEM_LIMIT = 232448      # shared memory an H100 block may opt into, bytes

RING_CASES = [
    # (rows, cols, D, P, lookahead, dtype, inputs)
    (8192, 4096, 4, 2, 1, torch.float32, 1),
    (8192, 4096, 4, 2, 3, torch.float32, 1),
    (8192, 4096, 4, 2, 4, torch.float32, 2),
    (8192, 4096, 4, 2, 4, torch.bfloat16, 1),
    (8192, 4096, 16, 1, 2, torch.float32, 0),
    (16384, 256, 4, 2, 3, torch.float32, 2),
    (44, 256, 4, 2, 3, torch.float32, 1),
    (40, 640, 8, 1, 1, torch.bfloat16, 2),
    (96, 1920, 2, 2, 4, torch.float32, 1),
]


def _ring_case(rows, cols, d, p, la, dtype, n_in, bm=0):
    spec = tsspecs.copy_spec(torch.empty(rows, cols))
    cfg = TConfig(d, p, lookahead=la, block_rows=bm)
    return cfg, tcg.plan_blocks(spec, cfg), ((dtype.itemsize,) * n_in,
                                             (dtype.itemsize,))


@pytest.mark.parametrize("rows,cols,d,p,la,dtype,n_in", RING_CASES)
def test_ring_tiles_cover_each_segment_once_and_fit(rows, cols, d, p, la,
                                                    dtype, n_in):
    """The step tile is a whole number of 128-column sub-portions that
    divides the row (so a segment's (row block, tile) steps cover it
    once), at most one box's 256 sub-portions, and fits the limit.  It
    is the widest tile whose ring lets two blocks share an SM (a
    writes-only ring: the widest that fits one), or 128 columns where no
    tile does (a step's copies no longer grow as the tile narrows).  The grid is one wave: one run of steps for each
    resident block, the runs partitioning the steps, none empty."""
    cfg, bp, sizes = _ring_case(rows, cols, d, p, la, dtype, n_in)
    tw = tmanual.ring_tile(bp, cfg, SMEM_LIMIT, *sizes)
    assert tw % 128 == 0 and bp.cols % tw == 0 and tw // 128 <= 256
    smem = tmanual.ring_smem(*sizes, d, bp.bm, tw, la)
    assert smem <= SMEM_LIMIT

    want = 2 if n_in else 1              # a writes-only ring: one block

    def fits(w):
        need = tmanual.ring_smem(*sizes, d, bp.bm, w, la)
        return (need <= SMEM_LIMIT
                and tmanual.ring_blocks_per_sm(need) >= want)
    tiles = [u * 128 for u in range(1, min(bp.cols // 128, 256) + 1)
             if bp.cols % (u * 128) == 0]
    if any(fits(w) for w in tiles):
        assert fits(tw) and not any(fits(w) for w in tiles if w > tw)
    else:
        assert tw == 128
    steps = bp.rows // d // bp.bm * (bp.cols // tw)
    per_sm = tmanual.ring_blocks_per_sm(smem)
    assert per_sm in (1, 2)
    for sms in (1, 7, 132):
        per, blocks = tmanual.ring_runs(steps, sms, per_sm)
        assert per >= 1 and (blocks - 1) * per < steps <= blocks * per
        assert blocks <= per_sm * sms          # resident at once


BOX_CASES = RING_CASES + [
    # (rows, cols, D, P, lookahead, dtype, inputs, block_rows)
    (1200, 128, 1, 1, 1, torch.bfloat16, 1, 300),     # bm > 256: 2 boxes
    (96, 384, 2, 1, 3, torch.float16, 2, 3),
]


@pytest.mark.parametrize("case", BOX_CASES)
def test_ring_box_plan(case):
    """The TMA boxes of every step (``ring_boxes``) cover each segment's
    ``[rows, cols]`` once, each box at most 256 elements a side (a 3-D
    box of ``(128, tw/128, bh)``) with 16-byte multiples of inner bytes;
    every stage and box lands 128-byte aligned in shared memory; a
    slot's expect-tx bytes are its boxes' bytes; the blocks' runs
    partition the steps in one wave."""
    rows, cols, d, p, la, dtype, n_in, *bm = case
    cfg, bp, sizes = _ring_case(rows, cols, d, p, la, dtype, n_in, *bm)
    isz = dtype.itemsize
    name = ("stream_init", "stream_copy", "stream_triad")[n_in]
    plan = tmanual.ring_plan(name, dtype, bp, cfg, sms=7)
    tw, bh = plan.tw, plan.bh
    assert bh <= 256 and bp.bm % bh == 0 and tw // 128 <= 256
    assert 128 * isz % 16 == 0
    covered = np.zeros((bp.rows, bp.cols), dtype=np.int32)
    for step in range(plan.steps):
        boxes = tmanual.ring_boxes(bp, tw, step)
        assert len(boxes) == plan.copies == d * bp.bm // bh
        for row, col, nr, nc, off in boxes:
            assert (nr, nc) == (bh, tw)
            covered[row:row + nr, col:col + nc] += 1
            assert off * isz % 128 == 0
        # expect-tx: the slot's bytes are its boxes' bytes
        assert sum(nr * nc for _, _, nr, nc, _ in boxes) * isz == \
            d * bp.bm * tw * isz
        assert sorted(o for *_, o in boxes) == \
            [i * bh * tw for i in range(len(boxes))]
    assert (covered == 1).all()
    layout = tmanual.ring_layout(*sizes, d, bp.bm, tw, la)
    offsets = [o for group in (*layout.inputs, *layout.outputs) for o in group]
    assert all(o % 128 == 0 for o in offsets)
    assert plan.box_bytes == tuple(bh * tw * e for e in (*sizes[0], *sizes[1]))
    assert plan.smem == tmanual.ring_smem(*sizes, d, bp.bm, tw, la)
    runs = [range(b * plan.per, min((b + 1) * plan.per, plan.steps))
            for b in range(plan.blocks)]
    assert sorted(s for r in runs for s in r) == list(range(plan.steps))
    assert all(len(r) for r in runs) and plan.blocks <= plan.per_sm * 7


@pytest.mark.parametrize("d,la,dtype", [(16, 4, torch.float32),
                                        (16, 8, torch.bfloat16),
                                        (8, 16, torch.float32)])
def test_ring_that_cannot_fit_raises_naming_the_bytes(d, la, dtype):
    spec = tsspecs.copy_spec(torch.empty(8192, 4096))
    cfg = TConfig(d, 1, lookahead=la)
    bp = tcg.plan_blocks(spec, cfg)
    isz = dtype.itemsize
    need = tmanual.ring_smem((isz,), (isz,), d, bp.bm, 128, la)
    assert need > SMEM_LIMIT
    with pytest.raises(ValueError, match=f"{need} bytes"):
        tmanual.ring_tile(bp, cfg, SMEM_LIMIT, (isz,), (isz,))
    with pytest.raises(ValueError, match="does not fit shared memory"):
        tmanual.ring_tile(bp, cfg, SMEM_LIMIT, (isz, isz), (isz,))
    assert cfg.stride_unroll == d and cfg.lookahead == la


def test_k4_refuses_what_it_does_not_take():
    """A K4-eligible spec with no ring body yet (``transpose_gen``) raises
    naming ``_emit_manual``; a rank-1 ``(stride,)`` side write is no
    longer refused: on CPU tensors the ring's plain version runs it,
    whatever its name, and returns the ``[rows]`` statistic."""
    x = torch.zeros(16, 256)
    cfg = TConfig(4, 2, lookahead=3)
    other = dataclasses.replace(tsspecs.copy_spec(x), name="transpose_gen")
    assert tcg.template_of(other, cfg) == "K4"
    with pytest.raises(NotImplementedError, match="_emit_manual"):
        tcg.emit_spec(other, [x], cfg)
    side = dataclasses.replace(          # a side write with no body's name
        tsspecs.copy_spec(x), name="transpose_gen",
        writes=(tcg.Access("y", ("i", "j")), tcg.Access("s", ("i",))),
        body=lambda env: (env["x"], env["x"].sum(-1)))
    assert tcg.template_of(side, cfg) == "K4"
    bp = tcg.plan_blocks(side, cfg)
    x = torch.from_numpy(_arrays((16, 256), 1, seed=21)[0])
    y, s = tmanual.emit(side, bp, [x], [], cfg)
    assert torch.equal(y, x) and torch.equal(s, x.sum(-1))


# ------------------------------------------ K4: the rank-1 side write

def _jrowstat_spec(rows, cols):
    """The JAX package's K4 test spec (``tests/test_codegen.py``
    ``_rowstat_spec``), built here with the JAX package's classes."""
    return jcg.TraversalSpec(
        name="t_rowstat",
        axes=(jcg.Axis("i", rows), jcg.Axis("j", cols)),
        reads=(jcg.Access("x", ("i", "j")),),
        writes=(jcg.Access("o", ("i", "j")), jcg.Access("r", ("i",))),
        body=lambda env: (env["x"] * 2.0,
                          env["x"].astype(jnp.float32).sum(axis=-1)),
        out_dtype=(jnp.float32, jnp.float32),
        full_width=True,
    )


def _row_sum_limit(x: np.ndarray) -> np.ndarray:
    """|a - b| between two f32 row sums of x taken in different orders:
    each lies within c 2^-24 Σ|x| of the exact sum, c = min(n, 8 √n)
    (Higham and Mary 2019, Thm 3.1)."""
    n = x.shape[-1]
    return 2 * min(n, 8 * n ** 0.5) * 2.0 ** -24 * np.abs(
        x.astype(np.float32)).sum(-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("la", [1, 3])
def test_k4_rowstat_matches_jax_emit_manual(monkeypatch, la, dtype):
    """``_rowstat_spec(16, 256)`` at lookahead 1 and 3 (the JAX test's
    points): the JAX ``_emit_manual`` in interpret mode against the
    port's K4 route (the ring's plain version on CPU tensors), equal
    block plans.  The map output ``2·x`` is exact in both packages (held
    to equality, stricter than the JAX test's rtol 1e-6); the row
    statistic is an f32 sum in each package's order, held to the JAX
    test's rtol 1e-6 plus the two sums' reassociation limit, in f32 and
    in bf16 alike (a bf16 x widens exactly)."""
    x = _arrays((16, 256), 1, seed=20 + la)[0]
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    cfg = JConfig(2, 1, lookahead=la)
    seen = {"jax": [], "port": []}
    for mod, key in ((jtransforms, "jax"), (ttransforms, "port")):
        real = mod.plan_blocks

        def plan(spec, config, *a, _real=real, _key=key, **kw):
            bp = _real(spec, config, *a, **kw)
            seen[_key].append((bp.d, bp.bm, bp.bn, bp.rows, bp.cols))
            return bp
        monkeypatch.setattr(mod, "plan_blocks", plan)
    ran = []
    real_manual = jemit._emit_manual

    def spy(*a, **kw):
        ran.append("_emit_manual")
        return real_manual(*a, **kw)
    monkeypatch.setattr(jemit, "_emit_manual", spy)
    want = jcg.emit_spec(_jrowstat_spec(16, 256), (jx,), cfg,
                         interpret=True)
    spec = tmanual.rowstat_spec(tx)
    assert tcg.template_of(spec, _tcfg(cfg)) == "K4"
    before = {n: k.launches for n, k in cuda.KERNELS.items()}
    got = tcg.emit_spec(spec, [tx], _tcfg(cfg))
    assert {n: k.launches for n, k in cuda.KERNELS.items()} == before
    assert ran == ["_emit_manual"] and seen["port"] == seen["jax"]
    assert tuple(got[0].shape) == (16, 256) and tuple(got[1].shape) == (16,)
    assert got[0].dtype == got[1].dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    xf = np.asarray(jnp.asarray(jx, jnp.float32))
    r_want = np.asarray(want[1])
    d = np.abs(got[1].numpy() - r_want)
    assert (d <= 1e-6 * np.abs(r_want) + _row_sum_limit(xf)).all(), d.max()


def test_k4_rowstat_ring_steps_by_whole_rows():
    """A ring with a rank-1 write steps by whole rows (one tile of every
    column); one that does not fit shared memory raises ValueError
    naming the bytes, without changing D or the lookahead."""
    spec = tmanual.rowstat_spec(torch.empty(8192, 2048))
    for dtype in (torch.float32, torch.bfloat16):
        sizes = tmanual.ring_sizes("t_rowstat", dtype)
        assert sizes == ((dtype.itemsize,), (4,), 1)
        cfg = TConfig(2, 1, lookahead=4, block_rows=2)
        bp = tcg.plan_blocks(spec, cfg)
        tw = tmanual.ring_tile(bp, cfg, SMEM_LIMIT, *sizes)
        assert tw == bp.cols == 2048
        cfg = TConfig(4, 1, lookahead=4, block_rows=8)
        bp = tcg.plan_blocks(spec, cfg)
        need = tmanual.ring_smem(sizes[0], sizes[1], 4, bp.bm, 2048, 4,
                                 sizes[2])
        assert need > SMEM_LIMIT
        with pytest.raises(ValueError, match=f"{need} bytes for a whole-row"):
            tmanual.ring_tile(bp, cfg, SMEM_LIMIT, *sizes)
        assert cfg.stride_unroll == 4 and cfg.lookahead == 4


# ------------------------------------------ read passes and oracles

@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_stream_read_two_passes_equal_one_sweep(d, sms):
    """The read's split into column-chunk partials and their in-order
    merge, through the wrappers' plain versions, equal the one-sweep
    spec for any chunking the card's SM count gives."""
    (x,) = _arrays((64, 384), 1, seed=d * sms)
    x2 = torch.from_numpy(x).reshape(d, -1)
    spec = tsspecs.read_spec(x2)
    bp = tcg.plan_blocks(spec, TConfig(d, 2))
    spc, chunks = skernel.read_chunks(bp, sms)
    nsub = bp.cols // 128
    assert (chunks - 1) * spc < nsub <= chunks * spc
    part = skernel.read_split_plain(spec, bp, x2, spc, chunks)
    assert tuple(part.shape) == (chunks, d)
    y = skernel.read_merge_plain(part)
    torch.testing.assert_close(y, tcg.evaluate(spec, [x2]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("nsub", [1, 3, 7, 255, 2 * 132 * 7 + 3])
@pytest.mark.parametrize("sms,per_sm", [(1, 2), (7, 1), (132, 2), (132, 4)])
def test_read_chunks_and_16bit_lane_split(nsub, sms, per_sm):
    """Pass 1's chunks cover a stream row's sub-portions once, none
    empty, at most ``per_sm`` a SM; in a chunk a lane loads 16 bytes a
    unit, a sub-portion in f32 and a pair in bf16 / f16, and an odd
    last sub-portion with one 8-byte load."""
    x2 = torch.empty(2, nsub * 128)
    bp = tcg.plan_blocks(tsspecs.read_spec(x2), TConfig(2, 2))
    spc, chunks = skernel.read_chunks(bp, sms, per_sm)
    assert chunks <= per_sm * sms and (chunks - 1) * spc < nsub
    assert nsub <= chunks * spc
    sizes = [min(spc, nsub - c * spc) for c in range(chunks)]
    assert sum(sizes) == nsub and min(sizes) >= 1
    for n in set(sizes):
        for isz, per in ((4, 1), (2, 2)):
            units = skernel.read_units(n, isz)
            subs = [q + i for q, b in units for i in range(b * per // 16)]
            assert subs == list(range(n))
            assert all(b == 16 for _, b in units[:-1])
            assert units[-1][1] == (8 if per == 2 and n % 2 else 16)
            assert len(units) == -(-n // per)


@pytest.mark.parametrize("chunks", [1, 31, 32, 33, 264])
def test_read_merge_plain_folds_in_the_kernels_order(chunks):
    """The plain merge is the kernel's fold: lane l of 32 sums chunks l,
    l+32, ... in order from 0, then the lanes fold by xor 16, 8, 4, 2, 1
    (each lane's sum and its partner's, commutative in IEEE f32), so
    the two agree bit for bit; an emulation in numpy f32 gives the same
    bits."""
    rng = np.random.default_rng(chunks)
    part = (rng.standard_normal((chunks, 5)) * 1e3).astype(np.float32)
    lanes = np.zeros((32, 5), dtype=np.float32)
    for c in range(chunks):
        lanes[c % 32] = lanes[c % 32] + part[c]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[np.arange(32) ^ off]
    got = skernel.read_merge_plain(torch.from_numpy(part))
    np.testing.assert_array_equal(got.numpy(), lanes[0])
    assert (lanes == lanes[0]).all()       # every lane holds the fold


def test_oracles_match_jax_oracles():
    (x,) = _arrays((32, 256), 1, seed=12)
    for d in (1, 2, 4, 8):
        np.testing.assert_allclose(
            tsref.read_ref(torch.from_numpy(x), d).numpy(),
            np.asarray(jsref.read_ref(jnp.asarray(x), d)), **TOL)
    np.testing.assert_array_equal(tsref.copy_ref(torch.from_numpy(x)).numpy(),
                                  np.asarray(jsref.copy_ref(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tsref.init_ref((8, 128), FILL, torch.float32).numpy(),
        np.asarray(jsref.init_ref((8, 128), FILL, jnp.float32)))


# ------------------------------------------------- device and dtypes

def test_stream_init_device_rule():
    """The one op that makes a tensor from nothing resolves its device:
    the card unless ``device="cpu"``, raising with no card; a writes-only
    spec through ``run_spec`` needs its device, and the plain version
    makes its output there."""
    if torch.cuda.is_available():
        pytest.skip("checks the rule where no card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsops.stream_init((8, 128), FILL)
    out = tsops.stream_init((8, 128), FILL, device="cpu", mode="ref")
    assert out.device.type == "cpu" and out.is_contiguous()
    build = functools.partial(tsspecs.init_spec, (8, 128), torch.bfloat16)
    with pytest.raises(ValueError, match="explicit device"):
        tcg.run_spec(build, (FILL,), TConfig(4, 1))
    got = tcg.run_spec(build, (FILL,), TConfig(4, 1), device="cpu")
    assert got.dtype == torch.bfloat16 and bool((got == FILL).all())
    spec = build(FILL)
    meta = tcg.evaluate(spec, [FILL], device="meta")
    assert meta.device.type == "meta" and tuple(meta.shape) == (8, 128)
    with pytest.raises(ValueError, match="writes-only"):
        tcg.emit_spec(spec, [FILL], TConfig(4, 1))


def test_cpu_ops_launch_nothing_and_bf16_keeps_its_dtype():
    (x,) = _arrays((48, 256), 1, seed=4)
    tx = torch.from_numpy(x).bfloat16()
    before = {n: k.launches for n, k in cuda.KERNELS.items()}
    assert tsops.stream_copy(tx).dtype == torch.bfloat16
    assert tsops.stream_copy_manual(
        tx, config=TConfig(4, 2, lookahead=3)).dtype == torch.bfloat16
    assert tsops.stream_read(tx).dtype == torch.float32
    assert tsops.stream_init((48, 256), FILL, torch.bfloat16,
                             device="cpu").dtype == torch.bfloat16
    want = jsops.stream_read(jnp.asarray(x, jnp.bfloat16), mode="ref",
                             config=JConfig(4, 2))
    np.testing.assert_allclose(tsops.stream_read(tx).numpy(),
                               np.asarray(want), **TOL)
    assert {n: k.launches for n, k in cuda.KERNELS.items()} == before
    assert set(cuda.KERNELS) >= {
        "stream_copy", "stream_triad", "stream_init", "stream_read",
        "stream_read_merge", "manual_ring_copy", "manual_ring_triad",
        "manual_ring_fill", "manual_ring_gemver_sum"}


@pytest.mark.parametrize("name,ins,want", [
    ("adamw_update", ("bfloat16", "bfloat16", "float32", "float32"),
     ("bfloat16", ("bfloat16", "float32", "float32"))),
    ("adamw_update", ("float16", "float16", "float32", "float32"),
     ("float16", ("float16", "float32", "float32"))),
    ("adamw_update", ("float32",) * 4,
     ("float32", ("float32", "float32", "float32"))),
    ("t_rowstat", ("bfloat16",), ("bfloat16", ("float32", "float32"))),
    ("t_rowstat", ("float32",), ("float32", ("float32", "float32"))),
    ("stream_copy", ("bfloat16",), ("bfloat16", ("bfloat16",))),
    ("adamw_update", ("bfloat16", "float32", "float32", "float32"), None),
    ("adamw_update", ("bfloat16", "bfloat16", "bfloat16", "float32"), None),
    ("t_rowstat", ("float16",), None),
    ("stream_triad", ("float32", "bfloat16"), None),
])
def test_ring_operand_dtypes(name, ins, want):
    """Each ring operand's dtype is the ring's type T or f32, as the body's
    signature says; the output dtypes follow it (adamw's p' in p's
    dtype, as the K1 kernel); a pairing no compiled instance takes raises
    TypeError before anything reaches the card."""
    arrays = [torch.empty(2, 128, dtype=getattr(torch, t)) for t in ins]
    out_dtypes = (torch.float32,) * len(tmanual.SIGNATURES[name][1])
    if want is None:
        with pytest.raises(TypeError, match=name):
            tmanual._ring_dtypes(name, arrays, out_dtypes)
        return
    dtype, in_dtypes, outs = tmanual._ring_dtypes(name, arrays, out_dtypes)
    assert dtype == getattr(torch, want[0])
    assert in_dtypes == tuple(getattr(torch, t) for t in ins)
    assert outs == tuple(getattr(torch, t) for t in want[1])
    in_sizes, out_sizes, n_row = tmanual.ring_sizes(name, dtype)
    assert in_sizes == tuple(t.itemsize for t in in_dtypes)
    ranks = tmanual.SIGNATURES[name][2]
    assert out_sizes == tuple(t.itemsize for t, r in zip(outs, ranks)
                              if r == 2)
    assert n_row == sum(r == 1 for r in ranks)
