"""The port's training slice against the JAX package.

Inputs are drawn with numpy from a seed and the same arrays go to both
packages; the JAX side runs in ``ref`` mode, or in ``interpret`` mode
where the point is the Pallas kernel's structure.  Covered: the fused
AdamW op at every conformance point and the registry sizes, its K1 and
K4 (``_emit_manual``) lowerings with equal block plans, ``adamw_step``
over a small tree, the rmsnorm gradient, attention, the causal LM's loss
and gradients, whole train steps (with microbatching), the data
pipeline, checkpoints across the two packages, the launcher, and the
rule that no Yi-9B parameter is padded or copied on its way to the
kernel.

Tolerances: the AdamW registry row's rtol 1e-5 / atol 1e-6 for the
update; 1e-5 relative in f32 for the gradients and the loss (sums taken
in another order); in bf16 the limits stated at each test.  The CUDA
kernels themselves are tested on the card in ``test_torch_cuda.py``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import codegen as jcg
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.codegen import emit as jemit
from repro.codegen import transforms as jtransforms
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.striding import StridingConfig as JConfig
from repro.data import DataConfig as JDataConfig
from repro.data import MemmapTokens as JMemmapTokens
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.kernels.adamw import ops as jaops
from repro.kernels.adamw import specs as jaspecs
from repro.models import attention as jattention
from repro.models import common as jcommon
from repro.models.lm import CausalLM as JCausalLM
from repro.registry import base as jreg
from repro.train import optimizer as jopt
from repro.train import trainstep as jtrainstep
from repro_torch import codegen as tcg
from repro_torch.checkpoint import CheckpointManager
from repro_torch.codegen import emit as temit
from repro_torch.codegen import transforms as ttransforms
from repro_torch.configs import get_config, reduced
from repro_torch.core.striding import StridingConfig as TConfig
from repro_torch.data import DataConfig, MemmapTokens, SyntheticTokens
from repro_torch.kernels import cuda
from repro_torch.kernels import manual as tmanual
from repro_torch.kernels.adamw import _ALIASED, _BENCH, _HYPER, _SIZES
from repro_torch.kernels.adamw import ops as taops
from repro_torch.kernels.adamw import specs as taspecs
from repro_torch.kernels.common import resolve_config
from repro_torch.kernels.rmsnorm import ops as trops
from repro_torch.models import attention as tattention
from repro_torch.models import common as tcommon
from repro_torch.models.lm import build_model, params_from_numpy
from repro_torch.train import optimizer as topt
from repro_torch.train import trainstep as ttrainstep

TOL = {"rtol": 1e-5, "atol": 1e-6}          # the adamw registry row's
CONFIGS = list(jreg.CONFORMANCE_CONFIGS)
POINTS = ([(label, cfg, "default") for label, cfg in CONFIGS]
          + [("aliased", JConfig(4, 1), "aliased"),
             ("bench", JConfig(2, 2), "bench")])


def _tcfg(c: JConfig) -> TConfig:
    return TConfig(c.stride_unroll, c.portion_unroll, c.lookahead,
                   c.arrangement, c.block_rows)


def _sizes(which: str) -> tuple[int, int]:
    s = {"default": _SIZES, "aliased": _ALIASED, "bench": _BENCH}[which]
    return s["rows"], s["cols"]


def _adamw_arrays(shape, seed: int) -> list:
    rng = np.random.default_rng(seed)
    p, g, m = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    v = np.abs(rng.standard_normal(shape)).astype(np.float32)
    return [p, g, m, v]


def _close(got, want, **tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **(tol or TOL))


def test_registry_sizes_are_the_jax_packages():
    row = jreg.get("adamw_update")
    assert row.default_sizes == _SIZES
    assert row.aliased_sizes == _ALIASED
    assert row.bench_sizes == _BENCH
    assert (row.rtol, row.atol) == (TOL["rtol"], TOL["atol"])
    assert taops._DEFAULT == _tcfg(jaops._DEFAULT)
    for n in (1, 100, 6000, 16384, 4096 * 1024):
        assert taops._blocking(n) == jaops._blocking(n)


# ------------------------------------------------------------ the op

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label,cfg,which", POINTS,
                         ids=[p[0] for p in POINTS])
def test_adamw_update_matches_jax_ref(label, cfg, which, dtype):
    """The port's op on CPU tensors (the body at the native shape)
    against the JAX op in ref mode, with the same explicit config: p' in
    p's dtype (bf16 p and g: the f32 p' rounds once, which both do), m'
    and v' in f32."""
    p, g, m, v = _adamw_arrays(_sizes(which), seed=1)
    jp, jg = (jnp.asarray(a).astype(dtype) for a in (p, g))
    tp, tg = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (p, g))
    want = jaops.adamw_update(jp, jg, jnp.asarray(m), jnp.asarray(v),
                              config=cfg, mode="ref", **_HYPER)
    got = taops.adamw_update(tp, tg, torch.from_numpy(m),
                             torch.from_numpy(v), config=_tcfg(cfg),
                             **_HYPER)
    assert got[0].dtype == tp.dtype
    assert got[1].dtype == got[2].dtype == torch.float32
    tol = TOL if dtype == "float32" else {"rtol": 2.0 ** -8, "atol": 1e-6}
    for a, b in zip(got, want):
        _close(a, b, **tol)


def test_adamw_oracle_matches_jax_oracle_and_the_op():
    """``ref.adamw_ref`` (the plain oracle, in the unfused order of the
    JAX ``adamw_ref``) against the JAX oracle and against the op."""
    from repro.kernels.adamw import ref as jaref
    from repro_torch.kernels.adamw import ref as taref
    p, g, m, v = _adamw_arrays(_sizes("default"), seed=3)
    want = jaref.adamw_ref(*(jnp.asarray(a) for a in (p, g, m, v)),
                           **_HYPER)
    args = [torch.from_numpy(a) for a in (p, g, m, v)]
    got = taref.adamw_ref(*args, **_HYPER)
    op = taops.adamw_update(*args, **_HYPER)
    for a, b, c in zip(got, want, op):
        _close(a, b)
        _close(a, c.numpy())


def test_adamw_update_takes_scalars_as_numbers_or_tensors():
    """Python numbers and 0-d tensors give the same update: both enter
    the body as f32, so 1 - b1 is the f32 subtraction (0.100000024 at
    b1 = 0.9, not the double 0.1)."""
    p, g, m, v = (torch.from_numpy(a) for a in _adamw_arrays((8, 128), 2))
    s = taops.scalars(torch.device("cpu"), *_HYPER.values())
    assert all(t.dtype == torch.float32 and t.ndim == 0 for t in s)
    a = taops.adamw_update(p, g, m, v, **_HYPER)
    b = taops.adamw_update(p, g, m, v, *s)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    b1 = s[1]
    assert float(1.0 - b1) == float(np.float32(1) - np.float32(0.9))


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


def _blocked_case(which: str, seed: int, d: int):
    """The op's [rows, cols] blocking of the registry arrays (zero-padded
    as both ops pad) plus the seven scalars, for both packages, and the
    config with D clamped to divide the rows as both ops clamp it."""
    rows0, cols0 = _sizes(which)
    n = rows0 * cols0
    rows, cols = jaops._blocking(n)
    arrays = [np.pad(a.reshape(-1), (0, rows * cols - n)).reshape(rows, cols)
              for a in _adamw_arrays((rows0, cols0), seed)]
    while rows % d:
        d -= 1
    jargs = [jnp.asarray(a) for a in arrays] + list(_HYPER.values())
    targs = ([torch.from_numpy(a) for a in arrays]
             + taops.scalars(torch.device("cpu"), *_HYPER.values()))
    return jargs, targs, d


def _port_emit(spec, args, cfg):
    """The port's emitter on CPU tensors: plan, pad, the kernel wrapper's
    plain version, crop; no launch."""
    before = {n: k.launches for n, k in cuda.KERNELS.items()}
    out = tcg.emit_spec(spec, args, cfg, device="cpu")
    assert all(k.launches == before.get(n, 0)
               for n, k in cuda.KERNELS.items())
    return out


@pytest.mark.parametrize("which", ["default", "aliased"])
@pytest.mark.parametrize("label,cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_adamw_k1_matches_jax_interpret(monkeypatch, label, cfg, which):
    """At lookahead 2 both emitters take K1: the JAX Pallas kernel in
    interpret mode against the port's front end and kernel wrapper on
    the op's blocking, with equal block plans."""
    jargs, targs, d = _blocked_case(which, seed=3, d=cfg.stride_unroll)
    cfg = dataclasses.replace(cfg, stride_unroll=d)
    seen = _plans(monkeypatch)
    jspec = jaspecs.adamw_spec(*jargs)
    tspec = taspecs.adamw_spec(*targs)
    assert tcg.template_of(tspec, _tcfg(cfg)) == "K1"
    want = jcg.emit_spec(jspec, jargs, cfg, interpret=True)
    got = _port_emit(tspec, targs, _tcfg(cfg))
    for a, b in zip(got, want):
        _close(a, b)
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 1


@pytest.mark.parametrize("lookahead", [1, 3, 4])
@pytest.mark.parametrize("which", ["default", "aliased"])
def test_adamw_k4_ring_matches_jax_emit_manual(monkeypatch, which,
                                               lookahead):
    """At a lookahead other than 2 both packages run the K4 template: the
    JAX ``_emit_manual`` in interpret mode against the port's ring
    (``kernels/manual.py``, its plain version on CPU tensors), three
    outputs, equal block plans."""
    jargs, targs, d = _blocked_case(which, seed=4, d=2)
    cfg = JConfig(d, 2, lookahead=lookahead)
    seen = _plans(monkeypatch)
    ran = []
    for mod, key in ((jemit, "_emit_manual"), (tmanual, "emit")):
        real = getattr(mod, key)

        def spy(*a, _real=real, _key=key, **kw):
            ran.append(_key)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, key, spy)
    want = jcg.emit_spec(jaspecs.adamw_spec(*jargs), jargs, cfg,
                         interpret=True)
    got = _port_emit(taspecs.adamw_spec(*targs), targs, _tcfg(cfg))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _close(a, b)
    assert ran == ["_emit_manual", "emit"]
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 1


@pytest.mark.parametrize("lookahead", [1, 2, 3, 4])
@pytest.mark.parametrize("label,cfg,which", POINTS,
                         ids=[p[0] for p in POINTS])
def test_adamw_plans_and_template_match_jax(lookahead, label, cfg, which):
    """Equal classification and block plan at every conformance point,
    and the port's template is K1 at lookahead 2 and K4 otherwise, as
    the JAX emitter's rule picks for this spec (plain (stride, vector)
    reads and writes)."""
    jargs, targs, d = _blocked_case(which, seed=0, d=cfg.stride_unroll)
    cfg = dataclasses.replace(cfg, stride_unroll=d, lookahead=lookahead)
    jspec, tspec = jaspecs.adamw_spec(*jargs), taspecs.adamw_spec(*targs)
    assert (dataclasses.asdict(tcg.classify(tspec))
            == dataclasses.asdict(jcg.classify(jspec)))
    jbp = jtransforms.plan_blocks(jspec, cfg)
    tbp = ttransforms.plan_blocks(tspec, _tcfg(cfg))
    assert (tbp.d, tbp.bm, tbp.bn, tbp.rows, tbp.cols) == (
        jbp.d, jbp.bm, jbp.bn, jbp.rows, jbp.cols)
    assert tcg.template_of(tspec, _tcfg(cfg)) == (
        "K1" if lookahead == 2 else "K4")


def test_ring_refuses_only_rank1_side_writes_and_unported_bodies():
    """The ring takes several (stride, vector) writes (adamw's three) and
    now a rank-1 side write (``t_rowstat``'s body); it refuses a name
    with no body, and a spec whose operands are not its body's."""
    spec = taspecs.adamw_spec(torch.zeros(16, 256), None, None, None)
    assert tmanual._refuse(spec) is None
    assert tmanual._refuse(tmanual.rowstat_spec(torch.zeros(16, 256))) is None
    side = dataclasses.replace(spec, writes=spec.writes[:2] + (
        tcg.Access("s", ("i",)),))
    assert "rank-1" not in tmanual._refuse(side)
    assert "writes rank (2, 2, 1)" in tmanual._refuse(side)
    other = dataclasses.replace(spec, name="transpose_gen")
    assert "no body" in tmanual._refuse(other)


@pytest.mark.parametrize("lookahead", [1, 3])
def test_adamw_k4_ring_bf16_p_matches_jax_emit_manual(monkeypatch,
                                                      lookahead):
    """A bf16 p and g with f32 m and v on the K4 ring: the JAX
    ``_emit_manual`` in interpret mode (each operand's ring in its own
    dtype) against the port's K4 route on CPU tensors, at the adamw
    row's tolerance; the ring's operand sizes are bf16 for p, g, p' and
    f32 for m, v, m', v'."""
    jargs, targs, d = _blocked_case("default", seed=5, d=2)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in jargs[:2]] + jargs[2:]
    targs = [a.bfloat16() for a in targs[:2]] + targs[2:]
    cfg = JConfig(d, 2, lookahead=lookahead)
    ran = []
    real = jemit._emit_manual

    def spy(*a, **kw):
        ran.append("_emit_manual")
        return real(*a, **kw)
    monkeypatch.setattr(jemit, "_emit_manual", spy)
    want = jcg.emit_spec(jaspecs.adamw_spec(*jargs), jargs, cfg,
                         interpret=True)
    tspec = taspecs.adamw_spec(*targs)
    assert tcg.template_of(tspec, _tcfg(cfg)) == "K4"
    assert tmanual._refuse(tspec) is None
    got = _port_emit(tspec, targs, _tcfg(cfg))
    assert ran == ["_emit_manual"] and len(got) == len(want) == 3
    for a, b in zip(got, want):
        _close(a, b)
    assert tmanual.ring_sizes("adamw_update", torch.bfloat16) == (
        (2, 2, 4, 4), (2, 4, 4), 0)


# ------------------------------------------------ no pad, no copy

YI_SHAPES = sorted({(64000, 4096), (4096, 64000), (4096, 4096),
                    (4096, 512), (4096, 11008), (11008, 4096), (4096,)})


@pytest.mark.parametrize("shape", YI_SHAPES)
def test_no_yi9b_parameter_pads_or_copies(monkeypatch, tmp_path, shape):
    """Every Yi-9B parameter shape blocks into whole [rows, 512] tiles
    whose rows the op's resolved D=2 streams (planned from its Traffic,
    as with no config given) split without padding: the flatten of p, g,
    m and v is a view, and the emitter's pad step hands back the same
    tensors.  Counted on meta tensors (no memory)."""
    from repro_torch.core.planner import Traffic
    from repro_torch.kernels import common
    from repro_torch.registry import tunecache
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tc.json"))
    tunecache.reset_default_cache()
    common.reset_plan_memo()
    assert get_config("yi-9b").padded_vocab == 64000
    n = math.prod(shape)
    rows, cols = taops._blocking(n)
    assert cols == 512 and rows * cols == n
    monkeypatch.setattr(taops.F, "pad", _no_pad)
    monkeypatch.setattr(temit.F, "pad", _no_pad)
    flat = []
    for dt in (torch.float32, torch.float32, torch.float32, torch.float32):
        a = torch.empty(shape, dtype=dt, device="meta")
        f = taops._flat(a, rows, cols, torch.float32)
        assert f._base is a or f._base is a._base, "the flatten copied"
        flat.append(f)
    cfg = resolve_config("adamw_update", shape, torch.float32, None, rows,
                         taops._DEFAULT,
                         traffic=Traffic(rows, cols, torch.float32,
                                         read_arrays=4, write_arrays=3),
                         mode="ref", device="cpu")
    assert cfg.stride_unroll == 2
    spec = taspecs.adamw_spec(*flat, *[0.0] * 7)
    bp = ttransforms.plan_blocks(spec, cfg)
    assert (bp.rows, bp.cols) == (rows, cols)
    assert all(a is b for a, b in zip(temit._pad_arrays(spec, bp, flat),
                                      flat))


def _no_pad(*a, **kw):
    raise AssertionError("a Yi-9B parameter was padded")


# ---------------------------------------------------- adamw_step

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((16, 32)).astype(np.float32),
            "b": rng.standard_normal((32,)).astype(np.float32),
            "e": (0.1 * rng.standard_normal((64, 16))).astype(np.float32)}


def test_adamw_step_matches_jax_over_three_steps():
    """Three steps over a small tree: lr (warmup then cosine), grad norm
    and clipping (the second step's grads are scaled past the clip),
    params, m and v; weight decay only on the ndim >= 2 leaves."""
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=1.0)
    jcfg, tcfg = jopt.AdamWConfig(**ocfg), topt.AdamWConfig(**ocfg)
    params = _tree(0)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate = jopt.adamw_init(jparams)
    tstate = topt.adamw_init(tparams)
    for step in range(3):
        grads = _tree(10 + step)
        if step == 1:
            grads = {k: 5 * v for k, v in grads.items()}
        jparams, jstate, jm = jopt.adamw_step(
            jcfg, jparams, {k: jnp.asarray(v) for k, v in grads.items()},
            jstate)
        tparams, tstate, tm = topt.adamw_step(
            tcfg, tparams, {k: torch.from_numpy(v) for k, v in grads.items()},
            tstate)
        _close(tm["lr"], jm["lr"])
        _close(tm["grad_norm"], jm["grad_norm"])
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        for k in params:
            _close(tparams[k], jparams[k])
            _close(tstate["m"][k], jstate["m"][k])
            _close(tstate["v"][k], jstate["v"][k])


# a list of mixed leaves: 1, 3 and 4 elements, 513, 64 x 64, a Mamba-2
# [H] of 80, and a bf16 leaf with an f32 gradient
MANY = [(1,), (3,), (2, 2), (513,), (64, 64), (80,)]


def _many(seed, pdt=torch.float32, gdt=None):
    gen = torch.Generator().manual_seed(seed)
    ps, gs, ms, vs = [], [], [], []
    for s in MANY:
        ps.append(torch.randn(*s, generator=gen).to(pdt))
        gs.append(torch.randn(*s, generator=gen).to(gdt or pdt))
        ms.append(torch.randn(*s, generator=gen))
        vs.append(torch.rand(*s, generator=gen))
    return ps, gs, ms, vs


@pytest.mark.parametrize("pdt,gdt", [(torch.float32, None),
                                     (torch.bfloat16, None),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float16, None)])
def test_adamw_update_many_plain_equals_the_op_leaf_by_leaf(pdt, gdt):
    """adamw_update_many's plain version equals adamw_update on each leaf
    bit for bit (each leaf's own weight decay), in place: every p, m and
    v keeps its storage."""
    ps, gs, ms, vs = _many(5, pdt, gdt)
    wds = [0.1 if len(s) > 1 else 0.0 for s in MANY]
    hyper = {k: v for k, v in _HYPER.items() if k != "wd"}
    want = [taops.adamw_update(p, g, m, v, wd=wd, **hyper)
            for p, g, m, v, wd in zip(ps, gs, ms, vs, wds)]
    ptrs = [t.data_ptr() for t in ps + ms + vs]
    s7 = torch.tensor(list(_HYPER.values()), dtype=torch.float32)
    taops.adamw_update_many(ps, gs, ms, vs, wds, s7)
    assert [t.data_ptr() for t in ps + ms + vs] == ptrs
    for (p, m, v), (wp, wm, wv) in zip(zip(ps, ms, vs), want):
        assert p.dtype == pdt
        assert torch.equal(p, wp) and torch.equal(m, wm) and torch.equal(v, wv)


@pytest.mark.parametrize("pdt", [torch.float32, torch.bfloat16])
def test_adamw_update_many_gscale_equals_the_two_pass_clip(pdt):
    """gscale fused equals the two-pass g.float() * scale, then the
    update, bit for bit; scalars as numbers or one f32 [7] alike."""
    ps, gs, ms, vs = _many(6, pdt)
    ref = [[t.clone() for t in x] for x in (ps, gs, ms, vs)]
    scale = torch.tensor(0.3713)
    taops.adamw_update_many(ps, gs, ms, vs, None, list(_HYPER.values()),
                            gscale=scale)
    for i, (p, g, m, v) in enumerate(zip(*ref)):
        wp, wm, wv = taops.adamw_update(p, g.float() * scale, m, v,
                                        **_HYPER)
        assert torch.equal(ps[i], wp) and torch.equal(ms[i], wm)
        assert torch.equal(vs[i], wv)


def test_adamw_step_updates_in_place_one_call_a_dtype(monkeypatch):
    """adamw_step groups the leaves by dtype (f32 and a bf16 leaf: two
    calls), passes the clip scale as gscale, and writes p, m and v where
    they lie."""
    gen = torch.Generator().manual_seed(4)
    params = {"w": torch.randn(16, 32, generator=gen),
              "h": torch.randn(80, generator=gen).bfloat16(),
              "b": torch.randn(32, generator=gen)}
    grads = {k: 5 * torch.randn(p.shape, generator=gen).to(p.dtype)
             for k, p in params.items()}
    state = topt.adamw_init(params)
    ptrs = {k: (p.data_ptr(), state["m"][k].data_ptr(),
                state["v"][k].data_ptr()) for k, p in params.items()}
    before = {k: p.clone() for k, p in params.items()}
    calls = []
    real = taops.adamw_update_many

    def spy(ps, *a, **kw):
        calls.append((len(ps), ps[0].dtype, kw["gscale"]))
        return real(ps, *a, **kw)
    monkeypatch.setattr(taops, "adamw_update_many", spy)
    _, state, metrics = topt.adamw_step(topt.AdamWConfig(lr=1e-2), params,
                                        grads, state)
    assert [(n, dt) for n, dt, _ in calls] == [(2, torch.float32),
                                               (1, torch.bfloat16)]
    assert all(float(sc) < 1.0 for *_, sc in calls)     # clipped
    for k, p in params.items():
        assert (p.data_ptr(), state["m"][k].data_ptr(),
                state["v"][k].data_ptr()) == ptrs[k]
        assert not torch.equal(p, before[k])


def test_cosine_lr_matches_jax():
    cfg = dict(lr=3e-3, warmup_steps=10, total_steps=50)
    for step in (0, 1, 9, 10, 11, 30, 50, 70):
        _close(topt.cosine_lr(topt.AdamWConfig(**cfg),
                              torch.tensor(step, dtype=torch.int32)),
               jopt.cosine_lr(jopt.AdamWConfig(**cfg),
                              jnp.asarray(step, jnp.int32)))


# ------------------------------------------------ model pieces

@pytest.mark.parametrize("dtype,tol", [
    ("float32", {"rtol": 1e-5, "atol": 1e-6}),
    # bf16 dx and dw round once each from f32 sums taken in another order:
    # one bf16 ulp (2^-8 relative)
    ("bfloat16", {"rtol": 2.0 ** -7, "atol": 1e-3})])
def test_rmsnorm_grad_matches_jax(dtype, tol):
    """The autograd.Function's dx and dw (closed form, f32) against
    ``jax.vjp`` of the JAX ``rms_norm`` (XLA differentiates the
    reference), on the same cotangent; forward unchanged."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    ct = rng.standard_normal((3, 5, 64)).astype(np.float32)
    eps = 1e-5

    def jf(x, w):
        return jcommon.rms_norm(x, w.astype(x.dtype), eps)
    jout, vjp = jax.vjp(jf, jnp.asarray(x).astype(dtype), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(ct).astype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = tcommon.rms_norm(tx, tw, eps)
    out.backward(torch.from_numpy(ct).to(out.dtype))
    _close(out, jout, **tol)
    assert tx.grad.dtype == tx.dtype and tw.grad.dtype == torch.float32
    _close(tx.grad, jdx, **tol)
    _close(tw.grad, jdw, **{"rtol": 2e-5, "atol": 1e-4} if dtype ==
           "float32" else {"rtol": 2.0 ** -7, "atol": 2e-2})


def test_rmsnorm_grad_is_the_autograd_of_the_plain_body():
    """The closed form (f32) equals autograd through the plain body in
    f64, where rounding is far below the f32 limit."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((4, 32)))
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(32))
    ct = torch.from_numpy(rng.standard_normal((4, 32)))
    x64, w64 = x.clone().requires_grad_(), w.clone().requires_grad_()
    inv = torch.rsqrt((x64 * x64).mean(-1, keepdim=True) + 1e-5)
    (x64 * inv * w64).backward(ct)
    x32, w32 = x.float().requires_grad_(), w.float().requires_grad_()
    tcommon.rms_norm(x32, w32, 1e-5).backward(ct.float())
    torch.testing.assert_close(x32.grad, x64.grad.float(), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(w32.grad, w64.grad.float(), rtol=1e-5,
                               atol=1e-5)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 6, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, (2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m))
        got = tcommon.cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(labels),
                                    None if m is None else
                                    torch.from_numpy(m))
        _close(got, want)


def _cfgs(compute_dtype, **kw):
    jcfg = dataclasses.replace(jreduced(jget_config("yi-9b")),
                               compute_dtype=compute_dtype, **kw)
    tcfg = dataclasses.replace(reduced(get_config("yi-9b")),
                               compute_dtype=compute_dtype, **kw)
    return jcfg, tcfg


def _carried(compute_dtype, seed=0, **kw):
    jcfg, tcfg = _cfgs(compute_dtype, **kw)
    jmodel = JCausalLM(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return (jmodel, jparams, build_model(tcfg),
            params_from_numpy(tcfg, tree, device="cpu", trainable=True))


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("compute_dtype,tol", [
    ("float32", {"rtol": 1e-5, "atol": 1e-5}),
    # bf16: both packages take the scores in f32 from the bf16 operands
    # (exact products, f32 sums) and round the output once; on the CPU
    # the two agree bit for bit (max |d| 0.0 measured)
    ("bfloat16", {"rtol": 0, "atol": 0})])
def test_attention_matches_jax(monkeypatch, compute_dtype, tol, chunked):
    """attn_forward on the same weights and input, whole and with the
    query axis in four checkpointed chunks (both packages' chunk size
    forced to sq/4)."""
    jmodel, jparams, tmodel, tparams = _carried(compute_dtype, seed=1)
    cfg = tmodel.cfg
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    if chunked:
        monkeypatch.setattr(jattention, "_pick_q_chunk",
                            lambda b, hq, sq, sk, budget=0: sq // 4)
        monkeypatch.setattr(tattention, "_pick_q_chunk",
                            lambda b, hq, sq, sk, budget=0: sq // 4)
    jrope = jcommon.make_rope(jnp.arange(16), cfg.head_dim, cfg.rope_theta,
                              cfg.rope_style)
    trope = tcommon.make_rope(torch.arange(16), cfg.head_dim,
                              cfg.rope_theta, cfg.rope_style)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"]["attn"])
    jout, _ = jattention.attn_forward(
        jp, jnp.asarray(x).astype(compute_dtype), jmodel.cfg, jrope)
    tout, _ = tattention.attn_forward(
        tparams.blocks[0].attn, torch.from_numpy(x).to(cfg.cdtype()), cfg,
        trope)
    assert tout.dtype == cfg.cdtype()
    _close(tout, jout, **tol)
    if not chunked:     # Yi-9B's train shape takes one block
        assert tattention._pick_q_chunk(2, 32, 4096, 4096) == \
            jattention._pick_q_chunk(2, 32, 4096, 4096) == 4096


def _named_grads_of_jax(jgrads, cfg) -> dict:
    """The JAX gradient tree under the port's parameter names."""
    out = {"embed": jgrads["embed"], "final_norm": jgrads["final_norm"],
           "head": jgrads["head"]}
    lp = jgrads["blocks"]["pos0"]
    for i in range(cfg.n_layers):
        out[f"blocks.{i}.norm1"] = lp["norm1"][i]
        out[f"blocks.{i}.norm2"] = lp["norm2"][i]
        for k in ("wq", "wk", "wv", "wo"):
            out[f"blocks.{i}.attn.{k}"] = lp["attn"][k][i]
        for k in ("w_in", "w_out", "w_gate"):
            out[f"blocks.{i}.ffn.{k}"] = lp["ffn"][k][i]
    return out


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("compute_dtype,tol,gtol", [
    ("float32", {"rtol": 1e-5, "atol": 1e-5}, 1e-4),
    # bf16: activations round at other points (the backward's bf16
    # casts in another order); the loss agrees to 2e-3,
    # each gradient to 5% of its largest entry
    ("bfloat16", {"rtol": 2e-3, "atol": 0}, 5e-2)])
def test_loss_and_grads_match_jax(compute_dtype, tol, gtol, remat):
    """``CausalLM.loss`` and its gradients on ``reduced(yi-9b)`` with
    carried f32 weights, against ``jax.value_and_grad`` of the JAX
    ``model.loss``, with and without activation checkpointing; 33 tokens
    give the chunked NLL 32 positions in 8 chunks."""
    jmodel, jparams, tmodel, tparams = _carried(compute_dtype, seed=2)
    toks = _tokens(tmodel.cfg, 2, 33, seed=9)

    def jloss(p):
        return jmodel.loss(p, {"tokens": jnp.asarray(toks)}, remat=remat)
    (jl, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tl, tmet = tmodel.loss(tparams, {"tokens": torch.from_numpy(toks)},
                           remat=remat)
    named = dict(tparams.named_parameters())
    tg = torch.autograd.grad(tl, list(named.values()))
    _close(tl, jl, **tol)
    _close(tmet["nll"], jmet["nll"], **tol)
    _close(tmet["aux"], jmet["aux"])
    want = _named_grads_of_jax(jg, tmodel.cfg)
    assert set(want) == set(named)
    for (name, _), g in zip(named.items(), tg):
        assert g.dtype == torch.float32, name
        w = np.asarray(want[name], np.float32)
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= gtol * scale, (name, err, scale)


def test_chunked_nll_matches_jax_with_uneven_chunks():
    """31 positions: 8 chunks do not divide them, both packages fall back
    to the largest count that does (1); 35 positions give 7."""
    jmodel, jparams, tmodel, tparams = _carried("float32", seed=3)
    for s in (32, 36):
        toks = _tokens(tmodel.cfg, 2, s, seed=s)
        jl, _ = jmodel.loss(jparams, {"tokens": jnp.asarray(toks)})
        tl, _ = tmodel.loss(tparams, {"tokens": torch.from_numpy(toks)})
        _close(tl, jl, rtol=1e-5, atol=1e-5)


def test_logits_match_jax():
    jmodel, jparams, tmodel, tparams = _carried("float32", seed=4)
    toks = _tokens(tmodel.cfg, 2, 8, seed=4)
    want = jmodel.logits(jparams, {"tokens": jnp.asarray(toks)})
    got = tmodel.logits(tparams, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 8, tmodel.cfg.vocab_size)
    _close(got, want, rtol=1e-5, atol=1e-5)


def test_params_from_numpy_carries_trainable_weights():
    """The extended ``params_from_numpy`` keeps ``param_dtype`` (f32)
    with gradients for training and still casts to the compute dtype
    without gradients for serving; both hold the JAX init's values."""
    jcfg, tcfg = _cfgs("bfloat16")
    tree = jax.tree.map(np.asarray,
                        JCausalLM(jcfg).init(jax.random.PRNGKey(0)))
    train = params_from_numpy(tcfg, tree, device="cpu", trainable=True)
    serve = params_from_numpy(tcfg, tree, device="cpu")
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in train.parameters())
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad
               for p in serve.parameters())
    np.testing.assert_array_equal(train.embed.detach().numpy(),
                                  tree["embed"])
    np.testing.assert_array_equal(
        train.blocks[1].ffn.w_gate.detach().numpy(),
        tree["blocks"]["pos0"]["ffn"]["w_gate"][1])
    assert torch.equal(serve.blocks[1].attn.wo,
                       train.blocks[1].attn.wo.to(torch.bfloat16))
    model = build_model(tcfg)
    drawn = model.init(seed=0, device="cpu", trainable=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in drawn.parameters())
    assert len(list(drawn.parameters())) == 9 * tcfg.n_layers + 3


# ------------------------------------------------------ train steps

def _port_state(tparams):
    return {"params": tparams, "opt_state": topt.adamw_init(
        dict(tparams.named_parameters()))}


# The train-step comparisons run without weight decay and with the
# default 0.1 (test_two_train_steps_with_weight_decay_match_jax): the
# port decays every per-layer tensor as the JAX package decays its
# stacked layer tree (test_weight_decay_of_norm_gains_matches_jax).
STEP_CFG = dict(lr=3e-3, warmup_steps=1, total_steps=4, weight_decay=0.0)


def _params_close(got: dict, want: dict, lr: float):
    """Params after a few AdamW steps.  An entry whose gradient is near
    zero (|g| ~ 1e-7, where sums taken in another order move g by its
    own size) gets an update m/sqrt(v) anywhere in about [-1, 1], so the
    limit is absolute and scaled by lr: 5e-2 lr for every entry (the
    largest seen, on a handful of such entries, is 1.4e-2 lr), and 1e-3
    lr for all but 0.1% of the entries of each tensor."""
    for name, p in got.items():
        d = np.abs(p.detach().float().numpy() - np.asarray(want[name]))
        assert d.max() <= 5e-2 * lr, (name, d.max() / lr)
        assert (d > 1e-3 * lr).mean() <= 1e-3, name


def test_two_train_steps_match_jax():
    """Two steps of ``make_train_step`` (f32 compute, remat) against the
    JAX train step on the same carried weights and batches: the metrics
    of each step and every parameter after the second."""
    _two_steps_match_jax(STEP_CFG)


def test_two_train_steps_with_weight_decay_match_jax():
    """The same two steps at weight decay 0.1: every layer norm's gain
    decays in both packages, final_norm in neither."""
    _two_steps_match_jax(dict(STEP_CFG, weight_decay=0.1))


def _two_steps_match_jax(ocfg, steps=2, batches=None):
    """``steps`` train steps of both packages on the same carried weights
    and batches (``batches(step, cfg)``, seeded numpy by default); returns
    each step's (port, JAX) metrics."""
    jmodel, jparams, tmodel, tparams = _carried("float32", seed=5)
    jstep = jax.jit(jtrainstep.make_train_step(jmodel, jopt.AdamWConfig(
        **ocfg)))
    tstep = ttrainstep.make_train_step(tmodel, topt.AdamWConfig(**ocfg))
    jstate = {"params": jparams, "opt_state": jopt.adamw_init(jparams)}
    tstate = _port_state(tparams)
    seen = []
    for step in range(steps):
        toks = (batches(step, tmodel.cfg) if batches
                else _tokens(tmodel.cfg, 4, 17, seed=20 + step))
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(toks)})
        assert set(tm) == set(jm) == {"loss", "nll", "aux", "lr",
                                      "grad_norm"}
        for k in jm:
            _close(tm[k], jm[k], rtol=1e-5, atol=1e-6)
        seen.append(({k: float(v) for k, v in tm.items()},
                     {k: float(v) for k, v in jm.items()}))
    _params_close(dict(tstate["params"].named_parameters()),
                  _named_grads_of_jax(jstate["params"], tmodel.cfg),
                  ocfg["lr"])
    assert int(tstate["opt_state"]["step"]) == steps
    return seen


def test_six_train_steps_at_the_chip_schedule_match_jax():
    """chip_smoke's train phase at reduced size: six steps of AdamW(lr
    3e-3, warmup 10, 50 total steps, weight decay 0.1) on
    ``SyntheticTokens(seed=0)``, whose loss rises over the later steps
    on the card.  The port's metrics follow the JAX package's at every
    step, so the rise is not the port's: the tokens are uniform over the
    vocabulary (nothing to learn, no loss below ln V), and the warmup
    raises the learning rate every step, so each update adds more noise
    than it removes."""
    data = SyntheticTokens(DataConfig(seq_len=33, global_batch=4,
                                      vocab_size=512))
    jdata = JSyntheticTokens(JDataConfig(seq_len=33, global_batch=4,
                                         vocab_size=512))

    def batches(step, cfg):
        toks = data.batch(step)
        np.testing.assert_array_equal(toks, jdata.batch(step))
        return toks

    seen = _two_steps_match_jax(dict(lr=3e-3, warmup_steps=10,
                                     total_steps=50), steps=6,
                                batches=batches)
    lrs = [tm["lr"] for tm, _ in seen]
    assert lrs == pytest.approx([3e-3 * s / 10 for s in range(1, 7)],
                                rel=1e-6)
    assert all(tm["loss"] > np.log(512) for tm, _ in seen)


def test_grad_accum_matches_one_batch_and_jax():
    """``grad_accum=2`` sums two microbatches' f32 grads and divides:
    the same step as one batch (equal token counts), and the JAX
    package's ``grad_accum=2`` step (whose metrics are loss, lr and
    grad_norm only)."""
    jmodel, jparams, tmodel, tparams = _carried("float32", seed=6)
    _, _, _, tparams1 = _carried("float32", seed=6)
    ocfg = STEP_CFG
    toks = _tokens(tmodel.cfg, 4, 17, seed=30)
    jstate = {"params": jparams, "opt_state": jopt.adamw_init(jparams)}
    jstate, jm = jax.jit(jtrainstep.make_train_step(
        jmodel, jopt.AdamWConfig(**ocfg), grad_accum=2))(
            jstate, {"tokens": jnp.asarray(toks)})
    s2, m2 = ttrainstep.make_train_step(
        tmodel, topt.AdamWConfig(**ocfg), grad_accum=2)(
            _port_state(tparams), {"tokens": torch.from_numpy(toks)})
    s1, m1 = ttrainstep.make_train_step(
        tmodel, topt.AdamWConfig(**ocfg))(
            _port_state(tparams1), {"tokens": torch.from_numpy(toks)})
    assert set(m2) == set(jm) == {"loss", "lr", "grad_norm"}
    for k in jm:
        _close(m2[k], jm[k], rtol=1e-5, atol=1e-6)
        _close(m2[k], m1[k].numpy(), rtol=1e-5, atol=1e-6)
    p2 = dict(s2["params"].named_parameters())
    _params_close(p2, _named_grads_of_jax(jstate["params"], tmodel.cfg),
                  ocfg["lr"])
    _params_close(p2, {k: p.detach().numpy() for k, p in
                       s1["params"].named_parameters()}, ocfg["lr"])


def test_weight_decay_of_norm_gains_matches_jax():
    """Weight decay by the JAX package's rule: it decays leaves of ndim
    >= 2, and its layer norm gains are stacked [n_layers, d], so they
    decay; final_norm [d] does not.  The port's per-layer gain
    ``blocks.0.norm1`` is [d] and decays as the JAX [1, d] ``norm1`` does;
    final_norm decays in neither.  With zero gradients the only change a
    step makes is the decay."""
    d, lr, wd = 8, 1e-2, 0.1
    cfg = dict(lr=lr, warmup_steps=0, total_steps=1, min_lr_ratio=1.0,
               weight_decay=wd)
    tparams = {"blocks.0.norm1": torch.ones(d), "final_norm": torch.ones(d),
               "w": torch.ones(d, d)}
    jparams = {"norm1": jnp.ones((1, d)), "final_norm": jnp.ones((d,)),
               "w": jnp.ones((d, d))}
    tparams, _, _ = topt.adamw_step(
        topt.AdamWConfig(**cfg), tparams,
        {k: torch.zeros_like(v) for k, v in tparams.items()},
        topt.adamw_init(tparams))
    jparams, _, _ = jopt.adamw_step(
        jopt.AdamWConfig(**cfg), jparams,
        {k: jnp.zeros_like(v) for k, v in jparams.items()},
        jopt.adamw_init(jparams))
    decayed = np.float32(1) - np.float32(lr) * np.float32(wd)
    for name in ("w", "final_norm"):
        np.testing.assert_array_equal(tparams[name].numpy(),
                                      np.asarray(jparams[name]))
    np.testing.assert_array_equal(tparams["blocks.0.norm1"].numpy(),
                                  np.asarray(jparams["norm1"])[0])
    np.testing.assert_allclose(tparams["w"].numpy(), decayed, rtol=1e-6)
    np.testing.assert_allclose(tparams["blocks.0.norm1"].numpy(), decayed,
                               rtol=1e-6)
    assert torch.equal(tparams["final_norm"], torch.ones(d))
    np.testing.assert_array_equal(np.asarray(jparams["final_norm"]),
                                  np.ones(d, np.float32))


def test_each_step_runs_the_kernels_the_chip_counts(monkeypatch):
    """The calls a step makes to the two kernel ops, on the CPU: rmsnorm
    2 per layer + the final norm forward, and the layers' 2 again when
    remat recomputes them (4L + 1: 33 at 8 layers); adamw_update_many
    once per parameter dtype (one here: the chip's one launch a step),
    over every parameter tensor (9L + 3: 75 at 8 layers)."""
    _, _, tmodel, tparams = _carried("float32", seed=7)
    calls = {"rmsnorm": 0, "adamw_update_many": 0}
    leaves = []

    def count(mod, name):
        real = getattr(mod, name)

        def spy(*a, **kw):
            calls[name] += 1
            if name == "adamw_update_many":
                leaves.append(len(a[0]))
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    count(trops, "rmsnorm")
    count(taops, "adamw_update_many")
    step = ttrainstep.make_train_step(tmodel, topt.AdamWConfig())
    toks = _tokens(tmodel.cfg, 2, 9, seed=1)
    step(_port_state(tparams), {"tokens": torch.from_numpy(toks)})
    n = tmodel.cfg.n_layers
    assert calls == {"rmsnorm": 4 * n + 1, "adamw_update_many": 1}
    assert leaves == [9 * n + 3]


# ------------------------------------------------ data, checkpoints

def test_synthetic_and_memmap_tokens_are_the_jax_packages(tmp_path):
    for cfg in (dict(seq_len=16, global_batch=4, vocab_size=1000),
                dict(seq_len=8, global_batch=6, vocab_size=50, n_shards=3,
                     shard_id=2, seed=7)):
        j, t = JSyntheticTokens(JDataConfig(**cfg)), SyntheticTokens(
            DataConfig(**cfg))
        for step in (0, 1, 5):
            np.testing.assert_array_equal(t.batch(step), j.batch(step))
    path = tmp_path / "tokens.bin"
    np.arange(40 * 16, dtype=np.int32).tofile(path)
    cfg = dict(seq_len=16, global_batch=4, vocab_size=1000,
               readahead_streams=4)
    j = JMemmapTokens(str(path), JDataConfig(**cfg))
    t = MemmapTokens(str(path), DataConfig(**cfg))
    assert t.offsets == j.offsets and t.d == j.d
    for step in range(4):
        np.testing.assert_array_equal(t.batch(step), j.batch(step))


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _tree_equal(a[k], b[k])
    else:
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
        b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else b
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("async_save", [True, False])
def test_checkpoints_cross_between_the_packages(tmp_path, async_save):
    """A train state written by the port restores through the JAX
    ``CheckpointManager`` and back into a port state, bit-equal; a JAX
    checkpoint restores through the port's manager as tensors on the
    given device.  Keep-N retention holds."""
    _, _, tmodel, tparams = _carried("float32", seed=8)
    state = _port_state(tparams)
    step = ttrainstep.make_train_step(tmodel, topt.AdamWConfig())
    state, _ = step(state, {"tokens": torch.from_numpy(
        _tokens(tmodel.cfg, 2, 9, seed=2))})
    tree = ttrainstep.state_tree(state)
    mgr = CheckpointManager(str(tmp_path / "port"), keep=2,
                            async_save=async_save)
    for s in (1, 2, 3):
        mgr.save(s, tree)
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    jstep, jtree = JCheckpointManager(str(tmp_path / "port")).restore()
    assert jstep == 3
    _tree_equal(jtree, tree)
    fresh = _port_state(_carried("float32", seed=9)[3])
    _, back = mgr.restore(device="cpu")
    ttrainstep.load_state_tree(fresh, back)
    _tree_equal(ttrainstep.state_tree(fresh), tree)

    jm = JCheckpointManager(str(tmp_path / "jax"), async_save=async_save)
    jt = {"a": {"b": jnp.arange(6.0).reshape(2, 3)},
          "step": jnp.asarray(4, jnp.int32)}
    jm.save(7, jt)
    jm.wait()
    s, got = CheckpointManager(str(tmp_path / "jax")).restore(device="cpu")
    assert s == 7 and isinstance(got["a"]["b"], torch.Tensor)
    _tree_equal(got, jax.tree.map(np.asarray, jt))


def test_checkpoint_save_errors_reach_the_caller(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), async_save=True)

    def fail(*a, **kw):
        raise OSError("disk full")
    monkeypatch.setattr(mgr, "_write", fail)
    mgr.save(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.all_steps() == []


# ------------------------------------------------------ launcher

def test_launcher_trains_on_cpu_when_asked(tmp_path, capsys):
    from repro_torch.launch import train
    ck = str(tmp_path / "ck")
    state = train.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                        "--seq", "16", "--log-every", "1", "--ckpt-dir", ck])
    out = capsys.readouterr().out
    assert out.count("loss") == 3 and "done; checkpoints: [3]" in out
    assert int(state["opt_state"]["step"]) == 3
    state = train.main(["--device", "cpu", "--steps", "4", "--batch", "2",
                        "--seq", "16", "--ckpt-dir", ck, "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert int(state["opt_state"]["step"]) == 4


def test_launcher_widths_and_depth():
    from repro_torch.launch import train
    run = train.setup(["--device", "cpu", "--layers", "1", "--steps", "1"])
    assert run.cfg.n_layers == 1 and run.cfg.d_model == 64
    args = train.parse(["--no-reduced", "--layers", "8"])
    assert args.reduced is False and args.layers == 8


def test_launcher_without_a_card_raises(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1"])
