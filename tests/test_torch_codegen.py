"""The PyTorch port's spec IR, block planning, combinators and emitter
front end, held against the JAX package on the same specs and inputs.

Specs are built on both sides from the same shapes; numeric inputs are
drawn once with numpy and handed to both packages.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import codegen as jcg
from repro.codegen import combine as jcomb
from repro.core.striding import StridingConfig as JConfig
from repro.kernels.decode_attn import specs as jdspecs
from repro.kernels.rmsnorm import specs as jrspecs
from repro.registry.base import CONFORMANCE_CONFIGS
from repro_torch import codegen as tcg
from repro_torch.codegen import combine as tcomb
from repro_torch.core.striding import StridingConfig as TConfig
from repro_torch.kernels import common
from repro_torch.kernels.decode_attn import specs as tdspecs
from repro_torch.kernels.rmsnorm import specs as trspecs

# the 6 conformance points: 5 configs at default sizes + D=4 at an
# aliased (power-of-two) size, as repro.registry.base.conformance_points
POINTS = [(label, cfg, False) for label, cfg in CONFORMANCE_CONFIGS]
POINTS.append(("aliased", JConfig(4, 1), True))


def _tcfg(c: JConfig) -> TConfig:
    return TConfig(c.stride_unroll, c.portion_unroll, c.lookahead,
                   c.arrangement, c.block_rows)


def _specs(kind: str, rows: int):
    """(JAX spec, port spec) of one family at ``rows`` stride rows."""
    if kind == "rmsnorm":
        dm = 256
        jx = jnp.zeros((rows, dm), jnp.float32)
        tx = torch.empty((rows, dm), device="meta")
        return (jrspecs.rmsnorm_spec(jx, jnp.zeros((dm,)), 1e-5),
                trspecs.rmsnorm_spec(tx, torch.empty(dm, device="meta"),
                                     1e-5))
    hkv, dh, hq, b = 2, 16, 4, 2
    masked = kind == "decode_masked"
    jargs = [jnp.zeros((b, rows, hkv * dh)), jnp.zeros((b, rows, hkv * dh)),
             jnp.zeros((b, hq * dh))]
    targs = [torch.empty(tuple(a.shape), device="meta") for a in jargs]
    if masked:
        jargs.append(jnp.zeros((b, rows)))
        targs.append(torch.empty((b, rows), device="meta"))
    return (jdspecs.decode_spec(hkv, dh, masked)(*jargs),
            tdspecs.decode_spec(hkv, dh, masked)(*targs))


KINDS = ("rmsnorm", "decode", "decode_masked")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("label,cfg,aliased", POINTS,
                         ids=[p[0] for p in POINTS])
@pytest.mark.parametrize("rows", [8, 13, 100])
def test_plan_blocks_and_classify_match_jax(kind, label, cfg, aliased, rows):
    rows = 1024 if aliased else rows
    jspec, tspec = _specs(kind, rows)
    jinfo, tinfo = jcg.classify(jspec), tcg.classify(tspec)
    assert dataclasses.asdict(tinfo) == dataclasses.asdict(jinfo)
    jbp = jcg.plan_blocks(jspec, cfg)
    tbp = tcg.plan_blocks(tspec, _tcfg(cfg))
    assert (tbp.d, tbp.bm, tbp.bn, tbp.rows, tbp.cols) == (
        jbp.d, jbp.bm, jbp.bn, jbp.rows, jbp.cols)
    jt, tt = jcg.traffic_of(jspec), tcg.traffic_of(tspec)
    assert (tt.rows, tt.cols, tt.read_arrays, tt.write_arrays,
            tt.resident_bytes) == (jt.rows, jt.cols, jt.read_arrays,
                                   jt.write_arrays, jt.resident_bytes)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("label,cfg,aliased", POINTS,
                         ids=[p[0] for p in POINTS])
def test_default_schedule_matches_jax(kind, label, cfg, aliased):
    # the schedule needs extents the block plan does not pad
    jspec, tspec = _specs(kind, 1024 if aliased else 64)
    js = jcg.default_schedule(jspec, cfg)
    ts = tcg.default_schedule(tspec, _tcfg(cfg))
    assert [dataclasses.astuple(l) for l in ts.loops] == [
        dataclasses.astuple(l) for l in js.loops]
    assert tcg.preserves_domain(ts)


# ------------------------------------------------------------ combinators

def _state(rng, groups, vwidth, b=3, empty=False):
    m = rng.standard_normal((b, groups)).astype(np.float32)
    if empty:
        m[:] = tcomb.NEG_INF
    num = rng.standard_normal((b, groups * vwidth)).astype(np.float32)
    den = rng.uniform(0.5, 4.0, (b, groups)).astype(np.float32)
    return m, num, den


def _t(state):
    return tuple(torch.from_numpy(x) for x in state)


def _j(state):
    return tuple(jnp.asarray(x) for x in state)


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("empty", ["none", "one", "both"])
def test_online_softmax_matches_jax(with_lse, empty):
    rng = np.random.default_rng(0)
    g, v = 3, 4
    a = _state(rng, g, v, empty=empty in ("one", "both"))
    b = _state(rng, g, v, empty=empty == "both")
    tc = tcomb.OnlineSoftmax(groups=g, vwidth=v, with_lse=with_lse)
    jc = jcomb.OnlineSoftmax(groups=g, vwidth=v, with_lse=with_lse)
    tm = tc.merge(_t(a), _t(b))
    jm = jc.merge(_j(a), _j(b))
    for x, y in zip(tm, jm):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-5,
                                   atol=2e-5)
        assert np.isfinite(x.numpy()).all()
    tf, jf = tc.finalize(tm), jc.finalize(jm)
    tf = tf if isinstance(tf, tuple) else (tf,)
    jf = jf if isinstance(jf, tuple) else (jf,)
    assert len(tf) == len(jf) == (2 if with_lse else 1)
    for x, y in zip(tf, jf):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-5,
                                   atol=2e-5)


def test_online_softmax_laws():
    """Associative, identity = init, and an all-masked segment state
    (NEG_INF, ΣV, rows) merges away with weight exactly 0."""
    rng = np.random.default_rng(1)
    c = tcomb.OnlineSoftmax(groups=2, vwidth=3)
    a, b, d = (_t(_state(rng, 2, 3)) for _ in range(3))
    left = c.merge(c.merge(a, b), d)
    right = c.merge(a, c.merge(b, d))
    for x, y in zip(left, right):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)
    ident = c.init([(3, 2), (3, 6), (3, 2)])
    for x, y in zip(c.merge(ident, a), a):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    masked = _t(_state(rng, 2, 3, empty=True))
    for x, y in zip(c.merge(a, masked), a):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    # two empty states stay finite (a true -inf would give NaN here)
    both = c.merge(masked, masked)
    assert all(torch.isfinite(x).all() for x in both)


@pytest.mark.parametrize("name", ["sum", "max"])
def test_sum_max_combine_match_jax(name):
    rng = np.random.default_rng(2)
    a, b = (rng.standard_normal((4, 5)).astype(np.float32) for _ in range(2))
    tc, jc = tcomb.resolve_combine(name), jcomb.resolve_combine(name)
    (t,) = tc.merge((torch.from_numpy(a),), (torch.from_numpy(b),))
    (j,) = jc.merge((jnp.asarray(a),), (jnp.asarray(b),))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=0)
    (ti,) = tc.init([(4, 5)])
    (ji,) = jc.init([(4, 5)])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ------------------------------------------------------- emit front end

def test_template_of_names_the_jax_lowering():
    _, rms = _specs("rmsnorm", 16)
    _, dec = _specs("decode_masked", 16)
    assert tcg.template_of(rms, TConfig(4, 1)) == "K1"
    assert tcg.template_of(dec, TConfig(4, 1)) == "K3"
    assert tcg.template_of(rms, TConfig(4, 1, lookahead=1)) == "K1"


def _copy_spec(rows=8, cols=128):
    # a copy under a name no kernel is registered for (the stream family's
    # own copy has K1 and K4 kernels)
    return tcg.TraversalSpec(
        name="unported_copy", axes=(tcg.Axis("i", rows), tcg.Axis("j", cols)),
        reads=(tcg.Access("a", ("i", "j")),),
        writes=(tcg.Access("c", ("i", "j")),), body=lambda env: env["a"])


def test_spec_without_a_hand_kernel_raises_naming_the_tpu_kernel():
    spec = _copy_spec()
    x = torch.zeros(8, 128)
    with pytest.raises(NotImplementedError, match="_emit_streaming"):
        tcg.emit_spec(spec, [x], TConfig(2, 1))
    with pytest.raises(NotImplementedError, match="_emit_manual"):
        tcg.emit_spec(spec, [x], TConfig(2, 1, lookahead=1))
    # the plain version still serves an explicit ref request
    torch.testing.assert_close(tcg.run_spec(lambda a: spec, [x],
                                            TConfig(2, 1), mode="ref"), x)


def test_stride_reduction_refuses_to_pad_the_stride_axis():
    b, s, hkv, dh, hq = 1, 12, 2, 16, 4
    args = [torch.zeros(b, s, hkv * dh), torch.zeros(b, s, hkv * dh),
            torch.zeros(b, hq * dh)]
    spec = tdspecs.decode_spec(hkv, dh)(*args)
    with pytest.raises(ValueError, match="cannot pad the stride axis"):
        tcg.emit_spec(spec, args, TConfig(5, 1))


@pytest.mark.parametrize("d", [1, 3, 4, 8])
def test_emit_spec_pads_and_crops_like_jax(d):
    """rmsnorm at 6 rows under D that does not divide them: the front end
    pads rows to the plan, runs the kernel wrapper (its plain version on
    CPU tensors) and crops back — equal to the JAX package's emitter."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 128)).astype(np.float32)
    w = rng.standard_normal(128).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    o, r = tcg.emit_spec(trspecs.rmsnorm_spec(tx, tw, 1e-5),
                         [tx, tw, 1e-5], TConfig(d, 1))
    jo, jr = jcg.emit_spec(
        jrspecs.rmsnorm_spec(jnp.asarray(x), jnp.asarray(w), 1e-5),
        [jnp.asarray(x), jnp.asarray(w), 1e-5], JConfig(d, 1),
        interpret=True)
    assert o.shape == (6, 128) and r.shape == (6,)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-5)


def test_evaluate_matches_jax_evaluate():
    rng = np.random.default_rng(4)
    b, s, hkv, dh, hq = 2, 16, 2, 16, 4
    arrs = [rng.standard_normal(sh).astype(np.float32) for sh in
            ((b, s, hkv * dh), (b, s, hkv * dh), (b, hq * dh))]
    mask = (np.arange(s)[None] < np.array([[5], [16]])).astype(np.float32)
    arrs.append(mask)
    t = tcg.evaluate(tdspecs.decode_spec(hkv, dh, True)(
        *map(torch.from_numpy, arrs)), [torch.from_numpy(a) for a in arrs])
    j = jcg.evaluate(jdspecs.decode_spec(hkv, dh, True)(
        *map(jnp.asarray, arrs)), [jnp.asarray(a) for a in arrs])
    for x, y in zip(t, j):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-5,
                                   atol=2e-5)


# ------------------------------------------------------- dispatch rules

def test_kernel_mode_follows_the_device():
    assert common.kernel_mode(torch.zeros(1)) == "ref"
    assert common.kernel_mode(torch.zeros(1), "ref") == "ref"
    assert common.kernel_mode(torch.empty(1, device="meta"),
                              "ref") == "ref"
    with pytest.raises(ValueError):
        common.kernel_mode(torch.zeros(1), "pallas")
    with pytest.raises(ValueError):
        common.kernel_mode(torch.empty(1, device="meta"))


@pytest.mark.parametrize("rows,want", [(8, 4), (6, 3), (7, 1), (1, 1)])
def test_resolve_config_clamps_d_to_a_divisor(rows, want):
    cfg = common.resolve_config("k", None, rows, TConfig(4, 1))
    assert cfg.stride_unroll == want
    assert common.resolve_config("k", TConfig(2, 2), 8,
                                 TConfig(4, 1)) == TConfig(2, 2)


@pytest.mark.parametrize("extent,d", [(8, 1), (8, 4), (96, 3), (1024, 8)])
def test_striding_helpers_match_jax(extent, d):
    from repro.core import striding as js
    from repro_torch.core import striding as ts
    assert ts.stream_offsets(extent, d) == js.stream_offsets(extent, d)
    for pref in (1, 5, 8, 64):
        assert ts.choose_block(extent, pref) == js.choose_block(extent, pref)
    assert ts.pad_to_multiple(extent + 1, d) == js.pad_to_multiple(
        extent + 1, d)
    with pytest.raises(ValueError):
        ts.stream_offsets(extent + 1, 2)          # odd extent, two streams
    with pytest.raises(ValueError):
        ts.StridingConfig(0, 1)
    assert ts.SINGLE_STRIDED == ts.StridingConfig(1, 1)
