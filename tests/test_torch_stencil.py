"""The port's jacobi2d, conv3x3 and doitgen families against the JAX
package.

Inputs are drawn once with numpy from a seed and the same arrays go to
both packages.  The ops are held against the JAX ops in ``mode="ref"``
at every conformance point (the five ``CONFORMANCE_CONFIGS`` at the
registry's ``default_sizes``, D=4 at its ``aliased_sizes``) and at a
ragged shape under each config: the stencils at 37 × 133 (131 output
columns, and rows that clamp D), doitgen at (3, 10, 40) × (40, 24) (m =
30 clamps D=4 to 3, and q = 10 then pads to 12).  Explicit configs go to
both sides.  The kernel structure is held against the JAX emitter in
interpret mode at the same points, the config passed straight to both
emitters (so 35 stencil rows pad to whole streams): the port's emitter
front end on CPU tensors plans, pads and crops around each kernel
wrapper's plain version, and must agree with the Pallas kernel, plan
the same blocks and name template K1.  Tolerances are the registry rows'
``rtol``/``atol``: 1e-5 for jacobi2d, 1e-4 for conv3x3 and doitgen.  The
CUDA kernels themselves are tested on the card in
``test_torch_cuda.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import codegen as jcg
from repro.codegen import transforms as jtransforms
from repro.core.striding import StridingConfig as JConfig
from repro.kernels.conv3x3 import ops as jcops
from repro.kernels.conv3x3 import ref as jcref
from repro.kernels.conv3x3 import specs as jcspecs
from repro.kernels.doitgen import ops as jdops
from repro.kernels.doitgen import ref as jdref
from repro.kernels.doitgen import specs as jdspecs
from repro.kernels.jacobi2d import ops as jjops
from repro.kernels.jacobi2d import ref as jjref
from repro.kernels.jacobi2d import specs as jjspecs
from repro.registry import base as jreg
from repro_torch import codegen as tcg
from repro_torch.codegen import transforms as ttransforms
from repro_torch.core.striding import StridingConfig as TConfig
from repro_torch.kernels import cuda, stencil
from repro_torch.kernels.conv3x3 import ops as tcops
from repro_torch.kernels.conv3x3 import ref as tcref
from repro_torch.kernels.conv3x3 import specs as tcspecs
from repro_torch.kernels.doitgen import kernel as tdkernel
from repro_torch.kernels.doitgen import ops as tdops
from repro_torch.kernels.doitgen import ref as tdref
from repro_torch.kernels.doitgen import specs as tdspecs
from repro_torch.kernels.jacobi2d import ops as tjops
from repro_torch.kernels.jacobi2d import ref as tjref
from repro_torch.kernels.jacobi2d import specs as tjspecs

CONFIGS = list(jreg.CONFORMANCE_CONFIGS)
KERNELS = ("jacobi2d", "conv3x3", "doitgen")
RAGGED = {"jacobi2d": {"h": 37, "w": 133}, "conv3x3": {"h": 37, "w": 133},
          "doitgen": {"r": 3, "q": 10, "s": 40, "p": 24}}
# (label, config, which sizes): every conformance point, then the ragged
# shape under every conformance config
POINTS = ([(label, cfg, "default") for label, cfg in CONFIGS]
          + [("aliased", JConfig(4, 1), "aliased")]
          + [(f"ragged-{label}", cfg, "ragged") for label, cfg in CONFIGS])
IDS = [p[0] for p in POINTS]


def _tcfg(c: JConfig) -> TConfig:
    return TConfig(c.stride_unroll, c.portion_unroll, c.lookahead,
                   c.arrangement, c.block_rows)


def _sizes(kernel: str, which: str) -> dict:
    if which == "ragged":
        return dict(RAGGED[kernel])
    row = jreg.get(kernel)
    return dict(row.default_sizes if which == "default"
                else row.aliased_sizes)


def _inputs(kernel: str, s: dict, seed: int) -> list:
    """numpy inputs of the registry row's op, in its argument order (the
    registry's doitgen draws a square C4; the ragged point a [s, p] one)."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    if kernel == "doitgen":
        return [r(s["r"], s["q"], s["s"]), r(s["s"], s.get("p", s["s"]))]
    x = r(s["h"], s["w"])
    return [x] if kernel == "jacobi2d" else [x, r(3, 3)]


def _j(args):
    return [jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for a in args]


def _t(args):
    return [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in args]


OPS = {
    "jacobi2d": (jjops.jacobi2d, tjops.jacobi2d),
    "conv3x3": (jcops.conv3x3, tcops.conv3x3),
    "doitgen": (jdops.doitgen, tdops.doitgen),
}


def _close(got, want, row):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=row.rtol,
                               atol=row.atol)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("label,cfg,which", POINTS, ids=IDS)
def test_op_matches_jax_ref(kernel, label, cfg, which):
    """The port's op on CPU tensors against the JAX op in ref mode, with
    the same explicit config on both sides."""
    args = _inputs(kernel, _sizes(kernel, which), seed=1)
    jop, top = OPS[kernel]
    want = jop(*_j(args), config=cfg, mode="ref")
    got = top(*_t(args), config=_tcfg(cfg))
    assert got.dtype == torch.float32
    _close(got, want, jreg.get(kernel))


# ------------------------------------------------- kernel structure

SPECS = {
    "jacobi2d": (jjspecs.jacobi_spec, tjspecs.jacobi_spec),
    "conv3x3": (jcspecs.conv3x3_spec, tcspecs.conv3x3_spec),
    "doitgen": (jdspecs.doitgen_spec, tdspecs.doitgen_spec),
}


def _spec_args(kernel: str, args: list, to) -> list:
    """The spec's inputs: conv3x3's weight matrix as nine scalars, as
    both packages' ops unpack it."""
    if kernel != "conv3x3":
        return to(args)
    x, w = to(args)
    return [x] + [w[r, c] for r in range(3) for c in range(3)]


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


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("label,cfg,which", POINTS, ids=IDS)
def test_kernel_structure_matches_jax_interpret(monkeypatch, kernel, label,
                                                cfg, which):
    """Each spec through both emitters: the JAX Pallas kernel in interpret
    mode against the port's front end and kernel wrapper (its plain
    version on CPU), with equal block plans and template K1.  The port
    launches nothing on CPU tensors."""
    args = _inputs(kernel, _sizes(kernel, which), seed=7)
    jb, tb = SPECS[kernel]
    jargs, targs = _spec_args(kernel, args, _j), _spec_args(kernel, args, _t)
    seen = _plans(monkeypatch)
    want = jcg.emit_spec(jb(*jargs), jargs, cfg, interpret=True)
    before = {n: k.launches for n, k in cuda.KERNELS.items()}
    tspec = tb(*targs)
    got = tcg.emit_spec(tspec, targs, _tcfg(cfg))
    assert {n: k.launches for n, k in cuda.KERNELS.items()} == before
    _close(got, want, jreg.get(kernel))
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 1
    assert tcg.template_of(tspec, _tcfg(cfg)) == "K1"
    assert tcg.HAND_KERNELS[tspec.name] == (
        "repro_torch.kernels.doitgen.kernel" if kernel == "doitgen"
        else "repro_torch.kernels.stencil")


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("which", ["default", "aliased", "ragged"])
@pytest.mark.parametrize("lookahead", [1, 2, 3, 4])
def test_block_plans_and_template_match_jax(kernel, which, lookahead):
    """The port classifies and plans each spec as the JAX package does
    (row-haloed stencils: one-row blocks at full, unpadded width; doitgen:
    a batch axis, a free axis and full-width p) and names K1 at every
    lookahead: halos and batch / free axes keep each spec off K4."""
    args = _inputs(kernel, _sizes(kernel, which), seed=0)
    jb, tb = SPECS[kernel]
    jspec = jb(*_spec_args(kernel, args, _j))
    tspec = tb(*_spec_args(kernel, args, _t))
    assert dataclasses.asdict(tcg.classify(tspec)) == dataclasses.asdict(
        jcg.classify(jspec))
    for d in (1, 2, 3, 4, 8):
        jcfg = JConfig(d, 1, lookahead=lookahead)
        jbp = jcg.plan_blocks(jspec, jcfg)
        tbp = tcg.plan_blocks(tspec, _tcfg(jcfg))
        assert (tbp.d, tbp.bm, tbp.bn, tbp.rows, tbp.cols) == (
            jbp.d, jbp.bm, jbp.bn, jbp.rows, jbp.cols)
        assert tcg.template_of(tspec, _tcfg(jcfg)) == "K1"
    if kernel != "doitgen":
        h, w = args[0].shape
        assert (tbp.bm, tbp.cols) == (1, w - 2)


# --------------------------------------------------------------- tap

@pytest.mark.parametrize("dr", [-1, 0, 1])
@pytest.mark.parametrize("dc", [-1, 0, 1])
def test_tap_matches_jax_tap(dr, dc):
    from repro.codegen import tap as jtap
    x = np.random.default_rng(dr * 3 + dc + 4).standard_normal(
        (7, 11)).astype(np.float32)
    halo = ((1, 1), (1, 1))
    got = tcg.tap(torch.from_numpy(x), halo, dr, dc)
    want = jtap(jnp.asarray(x), halo, dr, dc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tuple(got.shape) == (5, 9)


@pytest.mark.parametrize("offsets", [(2, 0), (0, -2), (-2, 1)])
def test_tap_refuses_an_offset_outside_the_halo(offsets):
    from repro.codegen import tap as jtap
    halo = ((1, 1), (1, 1))
    msg = "outside halo"
    with pytest.raises(ValueError, match=msg):
        jtap(jnp.zeros((5, 5)), halo, *offsets)
    with pytest.raises(ValueError, match=msg):
        tcg.tap(torch.zeros(5, 5), halo, *offsets)
    with pytest.raises(ValueError, match="one offset per dim"):
        tcg.tap(torch.zeros(5, 5), halo, 0)


# ----------------------------------------- oracles, sizes, the wrappers

def test_oracles_match_jax_oracles():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((19, 45)).astype(np.float32)
    w = rng.standard_normal((3, 3)).astype(np.float32)
    a = rng.standard_normal((3, 7, 40)).astype(np.float32)
    c4 = rng.standard_normal((40, 24)).astype(np.float32)
    pairs = [(tjref.jacobi2d_ref, jjref.jacobi2d_ref, [x]),
             (tcref.conv3x3_ref, jcref.conv3x3_ref, [x, w]),
             (tdref.doitgen_ref, jdref.doitgen_ref, [a, c4])]
    for tfn, jfn, args in pairs:
        np.testing.assert_allclose(tfn(*_t(args)).numpy(),
                                   np.asarray(jfn(*_j(args))),
                                   rtol=1e-4, atol=1e-4)


def test_registry_sizes_are_the_jax_rows():
    import importlib
    for name in KERNELS:
        # the package, not the op it exports under the same name
        pkg = importlib.import_module(f"repro_torch.kernels.{name}")
        row = jreg.get(name)
        assert pkg._SIZES == dict(row.default_sizes)
        assert pkg._ALIASED == dict(row.aliased_sizes)
        assert pkg.bench_sizes == dict(row.bench_sizes)


def test_ops_clamp_d_as_the_jax_ops_do(monkeypatch):
    """Default D=4 clamped to divide h - 2 (stencils) or r·q (doitgen),
    as the JAX ops pass their rows to ``resolve_config``."""
    seen = []

    def run_spec(build, inputs, cfg, mode=None):
        seen.append(cfg.stride_unroll)
        return tcg.evaluate(build(*inputs), inputs)
    for mod in (tjops, tcops, tdops):
        monkeypatch.setattr(mod, "run_spec", run_spec)
    tjops.jacobi2d(torch.zeros(37, 20))                        # 35 rows
    tjops.jacobi2d(torch.zeros(38, 20))                        # 36 rows
    tcops.conv3x3(torch.zeros(32, 20), torch.ones(3, 3))       # 30 rows
    tdops.doitgen(torch.zeros(3, 10, 8), torch.zeros(8, 4))    # m = 30
    tdops.doitgen(torch.zeros(2, 6, 8), torch.zeros(8, 4))     # m = 12
    assert seen == [1, 4, 3, 3, 4]


def test_cpu_ops_launch_nothing_and_keep_their_dtype():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((34, 130)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((2, 8, 32)).astype(np.float32))
    c4 = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    before = {n: k.launches for n, k in cuda.KERNELS.items()}
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        assert tjops.jacobi2d(x.to(dt)).dtype == dt
        assert tcops.conv3x3(x.to(dt), w.to(dt)).dtype == dt
        assert tdops.doitgen(a.to(dt), c4.to(dt)).dtype == dt
    assert {n: k.launches for n, k in cuda.KERNELS.items()} == before
    assert set(cuda.KERNELS) >= {"jacobi2d", "conv3x3", "doitgen"}
    # bf16 rounds the f32 body once, as the JAX package's bf16 ref does
    want = jjops.jacobi2d(jnp.asarray(x.numpy(), jnp.bfloat16), mode="ref",
                          config=JConfig(4, 1))
    np.testing.assert_array_equal(
        tjops.jacobi2d(x.bfloat16()).float().numpy(),
        np.asarray(want.astype(jnp.float32)))


def test_stencil_bodies_round_as_their_kernels():
    """The plain versions compute what ``csrc/stencil.cu`` computes: the
    body's f32 operations in its order, one rounding at the end."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((12, 40)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3)).astype(np.float32))
    got = tjops.jacobi2d(x)
    c, l, r = x[1:-1, 1:-1], x[1:-1, :-2], x[1:-1, 2:]
    u, b = x[:-2, 1:-1], x[2:, 1:-1]
    assert torch.equal(got, torch.tensor(0.2, dtype=torch.float32)
                       * ((((c + l) + r) + u) + b))
    acc = None
    for q in range(9):
        rr, cc = divmod(q, 3)
        term = w[rr, cc] * x[rr:rr + 10, cc:cc + 38]
        acc = term if acc is None else acc + term
    assert torch.equal(tcops.conv3x3(x, w), acc)


@pytest.mark.parametrize("rows,cols,d", [(2048, 2046, 4), (16384, 16384, 4),
                                         (16384, 16382, 4), (32, 128, 1),
                                         (36, 131, 4), (32, 126, 8),
                                         (7, 9, 1), (35, 131, 5),
                                         (8, 1, 8), (2048, 2045, 3),
                                         (2 ** 20, 128, 1)])
@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_stencil_runs_cover_each_segment_once(rows, cols, d, sms, itemsize):
    """Every stream's segment is cut into runs that cover it exactly once
    (the last may be short, none is empty); a run is 8 rows, halved only
    while the grid is under its blocks an SM, no longer than the segment
    and long enough for the grid's z extent; the tiles cover the
    columns."""
    from repro_torch.codegen.transforms import BlockPlan
    bp = BlockPlan(info=None, d=d, bm=1, bn=cols, rows=rows, cols=cols)
    run, runs = stencil.stencil_runs(bp, sms, itemsize)
    seg = rows // d
    assert 1 <= run <= seg and (runs - 1) * run < seg <= runs * run
    assert runs <= stencil._MAX_RUNS
    g = stencil.geometry(bp, itemsize, sms)
    assert (g.run, g.runs) == (run, runs)
    assert g.tile == stencil.THREADS * 16 // itemsize
    assert (g.tiles - 1) * g.tile < cols <= g.tiles * g.tile
    assert g.blocks == d * g.tiles * runs
    cap = -(-seg // stencil._MAX_RUNS)       # the shortest run the grid fits
    if cap < run < min(stencil._RUN, seg):   # halved: twice as long is
        assert (d * g.tiles * -(-seg // (2 * run))       # too few blocks
                < stencil._MIN_BLOCKS_PER_SM * sms)
    if run > stencil._RUN:                    # lengthened for the grid
        assert run == cap
    for r in (1, 3, seg, seg + 5):       # an explicit run length
        h = stencil.geometry(bp, itemsize, sms, run=r)
        assert (h.runs - 1) * h.run < seg <= h.runs * h.run


# (rows, cols, itemsize, D, 132 SMs) -> (vector, tiles, run, runs,
# blocks), worked by hand: tile = 128 threads x 16 bytes; a block a
# (stream, tile, run); run = 8, halved while D x tiles x runs < 15 x 132
# = 1980, at most seg, the last run short
@pytest.mark.parametrize("rows,cols,itemsize,d,want", [
    # x [2050, 2048]: seg 512; 2046 columns in 4 tiles of 512 (f32):
    # 4 x 4 x 64 = 1024 blocks at 8 rows, 2048 at 4; 2 tiles of 1024
    # (bf16): 512 blocks at 8 rows, 1024 at 4, 2048 at 2
    (2048, 2046, 4, 4, (4, 4, 4, 128, 2048)),
    (2048, 2046, 2, 4, (8, 2, 2, 256, 2048)),
    # x [16386, 16384]: seg 4096, 512 runs of 8; 16382 columns in 32
    # tiles (f32), 16 (bf16)
    (16384, 16382, 4, 4, (4, 32, 8, 512, 65536)),
    (16384, 16382, 2, 4, (8, 16, 8, 512, 32768)),
    # x [16386, 16386] (the pitch sweep) at D = 8: seg 2048, 32 tiles
    (16384, 16384, 4, 8, (4, 32, 8, 256, 65536)),
    # the ragged x [37, 133]: 35 output rows, 131 columns in one tile;
    # D = 5 (7 rows a segment) and D = 1: too few blocks at any run, so
    # runs of 1
    (35, 131, 2, 5, (8, 1, 1, 7, 35)),
    (35, 131, 4, 1, (4, 1, 1, 35, 35)),
    # one column, one row a segment: a run of 1
    (8, 1, 2, 8, (8, 1, 1, 1, 8)),
    # 2^20 rows in one stream: 131072 runs of 8 exceed the grid's 65535,
    # so runs of ceil(2^20 / 65535) = 17
    (2 ** 20, 128, 4, 1, (4, 1, 17, 61681, 61681)),
])
def test_stencil_geometry_at_hand_worked_shapes(rows, cols, itemsize, d,
                                                want):
    from repro_torch.codegen.transforms import BlockPlan
    bp = BlockPlan(info=None, d=d, bm=1, bn=cols, rows=rows, cols=cols)
    g = stencil.geometry(bp, itemsize, 132)
    assert (g.vec, g.tiles, g.run, g.runs, g.blocks) == want


# (cols, itemsize) -> (whole vectors, tail columns) of an output row
@pytest.mark.parametrize("cols,itemsize,want", [
    (2046, 4, (511, 2)), (2046, 2, (255, 6)), (2045, 2, (255, 5)),
    (2047, 2, (255, 7)), (2048, 2, (256, 0)), (16382, 4, (4095, 2)),
    (16382, 2, (2047, 6)), (131, 4, (32, 3)), (131, 2, (16, 3)),
    (1, 4, (0, 1)), (1, 2, (0, 1)), (7, 2, (0, 7))])
def test_stencil_split_by_dtype(cols, itemsize, want):
    assert stencil.split(cols, itemsize) == want
    assert stencil.vector(itemsize) * want[0] + want[1] == cols


# (row pitch in bytes) -> the pieces of rows 0-3 from a 16-byte aligned
# base: the widest of 16, 8, 4, 2 bytes dividing each row's address
@pytest.mark.parametrize("pitch,want", [
    (2048 * 2, [16, 16, 16, 16]),       # x [2050, 2048] bf16 input
    (2046 * 2, [16, 4, 8, 4]),          # its output, bf16
    (2046 * 4, [16, 8, 16, 8]),         # its output, f32
    (2045 * 2, [16, 2, 4, 2]),          # x [2050, 2047] bf16 output
    (16386 * 2, [16, 4, 8, 4]),         # x [16386, 16386] bf16 input
    (16386 * 4, [16, 8, 16, 8]),        # its f32 input
    (16382 * 2, [16, 4, 8, 4]),         # x [16386, 16384] output, bf16
    (133 * 2, [16, 2, 4, 2]),           # the ragged x [37, 133], bf16
    (133 * 4, [16, 4, 8, 4]),           # in f32
    (1 * 2, [16, 2, 4, 2]),             # one column of bf16
])
def test_stencil_row_pieces_by_pitch(pitch, want):
    assert [stencil.piece_bytes(r * pitch) for r in range(4)] == want
    assert stencil.piece_bytes(256 + 6) == 2


def test_conv_weights_widen_in_order():
    w = torch.arange(9, dtype=torch.float32).reshape(3, 3) / 7
    w9 = [w.bfloat16()[r, c] for r in range(3) for c in range(3)]
    got = stencil.conv_weights(w9, torch.device("cpu"))
    assert got.dtype == torch.float32 and tuple(got.shape) == (9,)
    assert torch.equal(got, w.bfloat16().float().reshape(9))
    assert torch.equal(stencil.conv_weights([0.5] * 9, "cpu"),
                       torch.full((9,), 0.5))


def test_conv_weights_hand_over_one_f32_storage():
    """The nine elements of a contiguous f32 [3, 3], as the op unpacks
    them, are handed over as that storage (no copy, no launch on the
    card); a transposed view or separate scalars are packed, each in
    C3_NAMES order."""
    w = torch.arange(9, dtype=torch.float32).reshape(3, 3) / 7
    w9 = [w[r, c] for r in range(3) for c in range(3)]
    got = stencil.conv_weights(w9, torch.device("cpu"))
    assert got.data_ptr() == w.data_ptr() and tuple(got.shape) == (9,)
    assert torch.equal(got, w.reshape(9))
    big = torch.arange(20, dtype=torch.float32)[5:14].reshape(3, 3)
    view = stencil.conv_weights([big[r, c] for r in range(3)
                                 for c in range(3)], "cpu")
    assert view.data_ptr() == big.data_ptr()
    assert torch.equal(view, torch.arange(5, 14, dtype=torch.float32))
    wt = w.t()
    packed = stencil.conv_weights([wt[r, c] for r in range(3)
                                   for c in range(3)], "cpu")
    assert packed.data_ptr() != w.data_ptr()
    assert torch.equal(packed, wt.reshape(9))
    loose = [torch.tensor(float(i)) for i in range(9)]
    assert torch.equal(stencil.conv_weights(loose, "cpu"),
                       torch.arange(9, dtype=torch.float32))
    # the kernel's own read: a 16-bit [3, 3]'s storage in its own type
    for dt in (torch.bfloat16, torch.float16):
        wd = w.to(dt)
        own = stencil.kernel_weights([wd[r, c] for r in range(3)
                                      for c in range(3)], "cpu")
        assert own.dtype == dt and own.data_ptr() == wd.data_ptr()
        assert torch.equal(own.float(), wd.float().reshape(9))
    assert stencil.kernel_weights(loose, "cpu").dtype == torch.float32


def test_check_arrays_takes_any_width_and_refuses_the_rest():
    """The stencil and doitgen launchers' check takes rows of any width
    and alignment (130 f32: 520 bytes) that the row-sweep check refuses,
    and still refuses dtypes, shapes and layouts."""
    x = torch.zeros(34 * 130 + 1)[1:].reshape(34, 130)   # 4-byte aligned
    cuda.check_arrays("jacobi2d", [x], [(34, 130)])
    with pytest.raises(ValueError):
        cuda.check_operands("jacobi2d", [x], [(34, 130)])
    with pytest.raises(TypeError):
        cuda.check_arrays("jacobi2d", [x.double()], [(34, 130)])
    a, c4 = torch.zeros(2, 8, 40), torch.zeros(40, 24)
    cuda.check_arrays("doitgen", [a, c4], [(2, 8, 40), (40, 24)])
    with pytest.raises(TypeError):
        cuda.check_arrays("doitgen", [a, c4.bfloat16()],
                          [(2, 8, 40), (40, 24)])
    with pytest.raises(ValueError):
        cuda.check_arrays("doitgen", [a, c4], [(2, 8, 40), (40, 32)])
    with pytest.raises(ValueError):
        cuda.check_arrays("doitgen", [a, c4.t().contiguous().t()],
                          [(2, 8, 40), (40, 24)])


def test_doitgen_plain_version_contracts_every_batch_element():
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.standard_normal((3, 10, 40)).astype(np.float32))
    c4 = torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32))
    got = tcg.emit_spec(tdspecs.doitgen_spec(a, c4), [a, c4], TConfig(4, 1))
    assert tuple(got.shape) == (3, 10, 24)
    for b in range(3):
        torch.testing.assert_close(got[b], a[b] @ c4, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("r,q,d", [(256, 256, 4), (16, 256, 4), (256, 256, 1),
                                   (256, 256, 8), (4, 8, 4), (3, 12, 3),
                                   (1, 40, 8)])
@pytest.mark.parametrize("sms", [1, 132])
def test_doitgen_geometry_divides_the_segment_and_fills_the_card(r, q, d,
                                                                 sms):
    """A block's run of rows per stream is a multiple of the plan's bm
    that divides the segment, the largest whose D·rb rows fit the tile
    (bm where none does); the tile is the largest of ``TILES`` whose
    grid keeps 15/16 of the SMs busy; a block takes the tile's width of
    p in f32,
    ``MMA_COLS`` in bf16 and f16; the grid counts every (batch element,
    run, p tile) once."""
    s, p = 16, 256
    a, c4 = torch.zeros(r, q, s), torch.zeros(s, p)
    bp = tcg.plan_blocks(tdspecs.doitgen_spec(a, c4), TConfig(d, 1))
    seg = bp.rows // bp.d
    for itemsize in (4, 2):
        geo = tdkernel.geometry(bp, r, s, p, itemsize, (0, 0, 0), sms)
        assert geo.rb % bp.bm == 0 and seg % geo.rb == 0
        assert geo.tile in tdkernel.TILES
        assert geo.cols == (geo.tile if itemsize == 4 else tdkernel.MMA_COLS)
        assert geo.rb == bp.bm or bp.d * geo.rb <= geo.tile
        larger = [rb for rb in range(geo.rb + bp.bm, seg + 1, bp.bm)
                  if seg % rb == 0 and bp.d * rb <= geo.tile]
        assert not larger
        assert geo.blocks == r * (seg // geo.rb) * -(-p // geo.cols)
        assert 16 * geo.blocks >= 15 * sms or geo.tile == tdkernel.TILES[-1]
        for tile in tdkernel.TILES:          # no larger tile fills the card
            if tile > geo.tile:
                rb = tdkernel._run_rows(bp, tile)
                cols = tile if itemsize == 4 else tdkernel.MMA_COLS
                assert 16 * r * (seg // rb) * -(-p // cols) < 15 * sms


@pytest.mark.parametrize("itemsize,r,tile,cols,rb,blocks", [
    (4, 16, 64, 64, 16, 256), (2, 16, 128, 64, 32, 128),
    (4, 256, 128, 128, 32, 1024), (2, 256, 128, 64, 32, 2048)])
def test_doitgen_geometry_at_the_bench_sizes(itemsize, r, tile, cols, rb,
                                             blocks):
    """At the bench size (16, 256, 256) x (256, 256), D=4, on 132 SMs:
    in f32 the 128 tile would give 64 blocks, so the 64 tile gives 256;
    in bf16 (64 columns a block) the 128 tile gives 128, one wave with
    4 SMs idle.  At a batch of 256 the 128 tile gives 1024 (f32) and
    2048 (bf16)."""
    a, c4 = torch.zeros(r, 256, 256), torch.zeros(256, 256)
    bp = tcg.plan_blocks(tdspecs.doitgen_spec(a, c4), TConfig(4, 1))
    geo = tdkernel.geometry(bp, r, 256, 256, itemsize, (256, 512, 768), 132)
    assert geo == tdkernel.Geometry(tile, cols, rb, True, blocks)
    assert 16 * geo.blocks >= 15 * 132


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("d,bm,passes", [(16, 0, {4: 2, 2: 1}),
                                         (8, 32, {4: 4, 2: 4})])
def test_doitgen_geometry_takes_several_passes(itemsize, d, bm, passes):
    """The card's multi-pass cases (``test_doitgen_two_passes_match_plain``)
    at the bench size on 132 SMs: D=16 takes two passes of the 64 tile
    in f32 (one of the 128 tile in bf16 and f16), D=8 at block_rows 32
    four passes of the 64 tile in every dtype, so each later pass's row
    table is rewritten after the previous pass's stores."""
    a, c4 = torch.zeros(16, 256, 256), torch.zeros(256, 256)
    bp = tcg.plan_blocks(tdspecs.doitgen_spec(a, c4),
                         TConfig(d, 1, block_rows=bm))
    geo = tdkernel.geometry(bp, 16, 256, 256, itemsize, (256, 512, 768), 132)
    assert -(-bp.d * geo.rb // geo.tile) == passes[itemsize]


# (itemsize, s, p, A, C4 and o offsets in bytes from a 256-byte boundary,
# the 16-byte instance?)
STAGING_CASES = [
    (2, 256, 256, (0, 0, 0), True), (2, 40, 200, (0, 0, 0), True),
    (2, 40, 100, (0, 0, 0), False), (2, 36, 256, (0, 0, 0), False),
    (2, 256, 256, (2, 0, 0), False), (2, 256, 256, (0, 8, 0), False),
    (2, 256, 256, (0, 0, 2), False), (2, 256, 256, (16, 32, 48), True),
    (4, 256, 100, (0, 0, 0), True), (4, 38, 256, (0, 0, 0), False),
    (4, 256, 102, (0, 0, 0), False), (4, 256, 256, (4, 0, 0), False),
    (4, 256, 256, (0, 0, 8), False), (4, 32, 24, (16, 16, 16), True)]


@pytest.mark.parametrize("itemsize,s,p,offsets,vec", STAGING_CASES)
def test_doitgen_geometry_staging_follows_the_alignment(itemsize, s, p,
                                                        offsets, vec):
    """The 16-byte instance needs s and p in whole 16-byte groups of
    elements (8 in bf16 and f16, 4 in f32) and A, C4 and o 16-byte
    aligned; anything else takes the element-wise staging instance."""
    a, c4 = torch.zeros(2, 64, s), torch.zeros(s, p)
    bp = tcg.plan_blocks(tdspecs.doitgen_spec(a, c4), TConfig(4, 1))
    ptrs = tuple(4096 * (i + 1) + off for i, off in enumerate(offsets))
    assert tdkernel.geometry(bp, 2, s, p, itemsize, ptrs, 132).vec is vec


def _doitgen_16bit_limit(a, c4, want, dtype):
    """|port - JAX| per element: both sum s f32 products in their own
    order (each within c 2^-24 Σ|A C4| of the exact dot, c = min(s,
    8 √s)), then round once into the 16-bit dtype (unit roundoff u:
    2^-8 in bf16, 2^-11 in f16): 2 c 2^-24 Σ|A C4| + 2 u |want|."""
    s = a.shape[-1]
    u = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -11
    terms = np.einsum("rqs,sp->rqp", np.abs(a), np.abs(c4))
    return (2 * min(s, 8 * s ** 0.5) * 2.0 ** -24 * terms
            + 2 * u * np.abs(want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("label,cfg,which", POINTS, ids=IDS)
def test_doitgen_16bit_matches_jax_ref(dtype, label, cfg, which):
    """doitgen in bf16 and f16: the port's op on CPU tensors against the
    JAX op in ref mode on the same 16-bit inputs, under the limit of
    :func:`_doitgen_16bit_limit`."""
    a, c4 = _inputs("doitgen", _sizes("doitgen", which), seed=3)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    ja, jc = jnp.asarray(a, jdt), jnp.asarray(c4, jdt)
    a16 = np.array(ja.astype(jnp.float32))
    c16 = np.array(jc.astype(jnp.float32))
    want = np.asarray(jdops.doitgen(ja, jc, config=cfg, mode="ref")
                      .astype(jnp.float32))
    got = tdops.doitgen(torch.from_numpy(a16).to(dtype),
                        torch.from_numpy(c16).to(dtype), config=_tcfg(cfg))
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    d = np.abs(got.float().numpy() - want)
    assert (d <= _doitgen_16bit_limit(a16, c16, want, dtype)).all()


# the 16-bit types of the kernels, as (id, torch dtype, jnp dtype)
SIXTEEN = [("bf16", torch.bfloat16, jnp.bfloat16),
           ("f16", torch.float16, jnp.float16)]


@pytest.mark.parametrize("kernel", ["jacobi2d", "conv3x3"])
@pytest.mark.parametrize("shape", [(37, 133), (34, 2047)],
                         ids=["37x133", "34x2047"])
@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("dt", SIXTEEN, ids=[s[0] for s in SIXTEEN])
def test_stencils_16bit_match_jax(kernel, shape, mode, dt):
    """jacobi2d and conv3x3 in bf16 and f16 on one numpy draw rounded to
    the type: the port's op (its plain version on CPU tensors) against
    the JAX op in ref mode, and the port's emitter against the JAX Pallas
    kernel in interpret mode, at the ragged 37 x 133 and at 2047 columns
    (an output row of 2045: no whole 16-byte vectors), within the
    registry row's rtol / atol; both round the f32 body once into the
    type."""
    _, tdt, jdt = dt
    rng = np.random.default_rng(shape[1] + len(kernel))
    args = [rng.standard_normal(shape).astype(np.float32)]
    if kernel == "conv3x3":
        args.append(rng.standard_normal((3, 3)).astype(np.float32))
    jargs = [jnp.asarray(a, jdt) for a in args]
    targs = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
             for a in jargs]
    cfg = JConfig(4, 1)
    if mode == "ref":
        want = OPS[kernel][0](*jargs, config=cfg, mode="ref")
        got = OPS[kernel][1](*targs, config=_tcfg(cfg))
    else:
        jb, tb = SPECS[kernel]
        js, ts = _spec_args(kernel, jargs, list), _spec_args(kernel, targs,
                                                             list)
        want = jcg.emit_spec(jb(*js), js, cfg, interpret=True)
        got = tcg.emit_spec(tb(*ts), ts, _tcfg(cfg))
    assert got.dtype == tdt
    row = jreg.get(kernel)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=row.rtol, atol=row.atol)
