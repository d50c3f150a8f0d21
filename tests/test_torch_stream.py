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


@pytest.mark.parametrize("rows,cols,d,p,la,dtype,n_in", RING_CASES)
def test_ring_tiles_cover_each_segment_once_and_fit(rows, cols, d, p, la,
                                                    dtype, n_in):
    """The step tile is a whole number of 128-column sub-portions that
    divides the row (so a segment's (row block, tile) steps cover it
    once), the widest whose ring fits the limit; the blocks' runs
    partition the steps, none empty."""
    spec = tsspecs.copy_spec(torch.empty(rows, cols))
    cfg = TConfig(d, p, lookahead=la)
    bp = tcg.plan_blocks(spec, cfg)
    limit = SMEM_LIMIT
    sizes = ((dtype.itemsize,) * n_in, (dtype.itemsize,))
    tw = tmanual.ring_tile(bp, cfg, limit, *sizes)
    assert tw % 128 == 0 and bp.cols % tw == 0
    assert tmanual.ring_smem(*sizes, d, bp.bm, tw, la) <= limit
    wider = [u * 128 for u in range(tw // 128 + 1, bp.cols // 128 + 1)
             if bp.cols % (u * 128) == 0]
    assert all(tmanual.ring_smem(*sizes, d, bp.bm, w, la) > limit
               for w in wider)            # the widest that fits
    steps = bp.rows // d // bp.bm * (bp.cols // tw)
    for sms in (1, 7, 132):
        per, blocks = tmanual.ring_runs(steps, sms)
        assert per >= 1 and (blocks - 1) * per < steps <= blocks * per
        assert blocks <= max(1, 2 * sms)


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
