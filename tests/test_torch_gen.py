"""The five template instances the ``*_gen`` rows brought to the port —
``transpose`` (K1), ``rowstat`` and ``gemver_mxv2`` (K2), ``gemver_mxv1``
and ``gemver_mxv1_sum`` (K3) — and the emitter's refusals, against the
JAX package.

The instances run through the port's emitter front end on CPU tensors
(plan, pad, the kernel wrapper's plain version, crop) against the JAX
emitter in interpret mode (the Pallas kernel body on the CPU), at the
six conformance points and a ragged shape, on one numpy draw, at the
registry rows' tolerances; where the JAX emitter refuses, the port
refuses with the same exception type.  Each refusal of the JAX
``emit_spec`` and its templates is checked on the same spec in both
packages.  The CUDA kernels are held against these plain versions on
the card in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import codegen as jcg
from repro import registry as jregistry
from repro.core.striding import StridingConfig as JConfig
from repro.kernels import gen as jgen
from repro.kernels.gemver import specs as jgspecs
from repro_torch import codegen as tcg
from repro_torch.core.striding import StridingConfig as TConfig
from repro_torch.kernels import cuda
from repro_torch.kernels import gen as tgen
from repro_torch.kernels.gemver import specs as tgspecs

CONFIGS = [(label, cfg) for label, cfg in jregistry.base.CONFORMANCE_CONFIGS]
RAGGED = {"m": 40, "n": 200}
POINTS = ([(label, cfg, "default") for label, cfg in CONFIGS]
          + [("aliased", JConfig(4, 1), "aliased"),
             ("ragged", JConfig(4, 2), "ragged")])
# spec → (JAX builder, port builder, registry row, template, scalars)
INSTANCES = {
    "transpose": (jgen.transpose_spec, tgen.transpose_spec,
                  "transpose_gen", "K1", ()),
    "rowstat": (jgen.rowstat_spec, tgen.rowstat_spec, "rowstat_gen", "K2",
                ()),
    "gemver_mxv2": (jgspecs.gemver_mxv2_spec, tgspecs.gemver_mxv2_spec,
                    "gemver_mxv2_gen", "K2", (1.5,)),
    "gemver_mxv1": (jgspecs.gemver_mxv1_spec, tgspecs.gemver_mxv1_spec,
                    "gemver_mxv1_gen", "K3", (1.2,)),
    "gemver_mxv1_sum": (jgspecs.gemver_mxv1_sum_spec,
                        tgspecs.gemver_mxv1_sum_spec, "gemver_mxv1_sum_gen",
                        "K3", (1.2,)),
}


def _tcfg(c: JConfig) -> TConfig:
    return TConfig(c.stride_unroll, c.portion_unroll, c.lookahead,
                   c.arrangement, c.block_rows)


def _arrays(name: str, s: dict, seed: int) -> list:
    rng = np.random.default_rng(seed)
    m, n = s["m"], s["n"]
    a = rng.standard_normal((m, n)).astype(np.float32)
    if name in ("transpose", "rowstat"):
        return [a]
    vec = n if name == "gemver_mxv2" else m
    return [a, rng.standard_normal(vec).astype(np.float32)]


def _outcome(fn):
    """The outputs as a tuple, or the type of the exception raised."""
    try:
        out = fn()
    except (ValueError, NotImplementedError) as exc:
        return type(exc)
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", list(INSTANCES))
@pytest.mark.parametrize("label,cfg,which", POINTS,
                         ids=[p[0] for p in POINTS])
def test_instance_matches_jax_interpret(name, label, cfg, which):
    """The port emitter on CPU tensors (its kernel wrapper's plain
    version) against the JAX emitter in interpret mode; the port names
    the template the JAX package lowers the spec through, and launches
    no CUDA kernel here."""
    jb, tb, row, template, scalars = INSTANCES[name]
    jrow = jregistry.get(row)
    sizes = (RAGGED if which == "ragged"
             else jrow.default_sizes if which == "default"
             else jrow.aliased_sizes)
    arrays = _arrays(name, dict(sizes), seed=11)
    jin = [jnp.asarray(a) for a in arrays] + list(scalars)
    tin = [torch.from_numpy(a) for a in arrays] + list(scalars)
    tspec = tb(*tin)
    assert tcg.template_of(tspec, _tcfg(cfg)) == template
    want = _outcome(lambda: jcg.emit_spec(jb(*jin), jin, cfg,
                                          interpret=True))
    before = {n: k.launches for n, k in cuda.KERNELS.items()}
    got = _outcome(lambda: tcg.emit_spec(tspec, tin, _tcfg(cfg)))
    assert all(k.launches == before.get(n, 0)
               for n, k in cuda.KERNELS.items())
    if isinstance(want, type):
        assert got is want, (label, got, want)
        return
    assert not isinstance(got, type), (label, got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=jrow.rtol,
                                   atol=jrow.atol)


def test_ragged_rowstat_is_refused_before_the_kernel():
    """Padding the reduced vector axis would feed zeros to the max: both
    emitters refuse with ValueError (the port before it looks its kernel
    up), and the plain version still serves it."""
    x = np.random.default_rng(3).standard_normal((48, 200)).astype(
        np.float32) - 10.0
    with pytest.raises(ValueError, match="non-'sum'"):
        jcg.emit_spec(jgen.rowstat_spec(jnp.asarray(x)), [jnp.asarray(x)],
                      JConfig(4, 2), interpret=True)
    t = torch.from_numpy(x)
    with pytest.raises(ValueError, match="non-'sum'"):
        tcg.emit_spec(tgen.rowstat_spec(t), [t], TConfig(4, 2))
    mx, sm = tgen.rowstat_gen(t, config=TConfig(4, 2))
    torch.testing.assert_close(mx, t.amax(-1))
    assert bool((mx < 0).all())


# ------------------------------------------------------------ refusals

def _refusal_specs(pkg):
    """Specs each JAX refusal is about, built in either package's IR."""
    cg = jcg if pkg == "jax" else tcg
    Axis, Access, TS = cg.Axis, cg.Access, cg.TraversalSpec

    per_write_k1 = TS(     # per-write combinators on a streaming nest
        name="per_write_k1", axes=(Axis("i", 16), Axis("j", 256)),
        reads=(Access("x", ("i", "j")),),
        writes=(Access("y", ("i", "j")), Access("s", ("i",))),
        body=lambda env: (env["x"], env["x"].sum(-1)),
        reduce=("sum", "max"))
    contracted = TS(       # a reduction contracted in the body, split
        name="contracted", axes=(Axis("i", 16), Axis("j", 512,
                                                     kind="reduction"),
                                 Axis("t", 1)),
        reads=(Access("x", ("i", "j")),),
        writes=(Access("y", ("i", "t")),),
        body=lambda env: env["x"].sum(-1)[..., None])
    per_write_k3 = TS(     # per-write combinators on a stride reduction
        name="per_write_k3", axes=(Axis("i", 16, kind="reduction"),
                                   Axis("j", 256)),
        reads=(Access("x", ("i", "j")),),
        writes=(Access("a", ("j",)), Access("b", ("j",))),
        body=lambda env: (env["x"].sum(0), env["x"].sum(0)),
        reduce=("sum", "max"))
    two_out_k3 = TS(       # two outputs off a non-finalizing combinator
        name="two_out_k3", axes=(Axis("i", 16, kind="reduction"),
                                 Axis("j", 256)),
        reads=(Access("x", ("i", "j")),),
        writes=(Access("a", ("j",)), Access("b", ("j",))),
        body=lambda env: (env["x"].sum(0), env["x"].sum(0)))
    return {
        "rowstat-ragged": (
            (jgen if pkg == "jax" else tgen).rowstat_spec(
                np.zeros((16, 200), np.float32)), (16, 200), ValueError,
            "non-'sum'"),
        "per-write-outside-k2": (per_write_k1, (16, 256),
                                 NotImplementedError, "per-write"),
        "contracted-without-full-width": (contracted, (16, 512),
                                          NotImplementedError,
                                          "full_width"),
        "k3-per-write": (per_write_k3, (16, 256), NotImplementedError,
                         "per-write"),
        "k3-two-outputs-one-state": (two_out_k3, (16, 256),
                                     NotImplementedError, "finalizing"),
        "k3-pads-the-stride-axis": (
            (jgspecs if pkg == "jax" else tgspecs).gemver_mxv1_spec(
                np.zeros((18, 256), np.float32), None), (18, 256),
            ValueError, "cannot pad"),
    }


REFUSALS = list(_refusal_specs("jax"))


@pytest.mark.parametrize("case", REFUSALS)
def test_refusal_matches_jax(case):
    """Each refusal of the JAX ``emit_spec`` (padding a reduced vector
    axis under a non-'sum' combinator, a stride-axis reduction that would
    pad its stride axis: ValueError) and of its templates (per-write
    combinators outside K2 or on K3, a body-contracted reduction without
    ``full_width``, several K3 outputs off one non-finalizing state:
    NotImplementedError) raises the same type in the port on the same
    spec, before any kernel is looked up."""
    jspec, shape, exc, why = _refusal_specs("jax")[case]
    tspec = _refusal_specs("torch")[case][0]
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    extra = [np.zeros(shape[0], np.float32)] * (len(jspec.reads) - 1)
    jin = [jnp.asarray(x)] + [jnp.asarray(e) for e in extra] + [1.0] * len(
        jspec.scalars)
    tin = [torch.from_numpy(x)] + [torch.from_numpy(e) for e in extra] + [
        1.0] * len(tspec.scalars)
    cfg = JConfig(4, 2)
    with pytest.raises(exc, match=why):
        jcg.emit_spec(jspec, jin, cfg, interpret=True)
    with pytest.raises(exc, match=why):
        tcg.emit_spec(tspec, tin, _tcfg(cfg))


# --------------------------------------------------------- the gen ops

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gen_ops_match_jax_ops_in_their_other_forms(dtype):
    """The ops' forms the registry rows do not call: ``decode_attn_gen``
    without the lse, ``rmsnorm_gen`` without the inverse rms and on a
    [2, 16, dm] batch, ``transpose_gen`` and ``rowstat_gen`` in bf16
    (a transpose is exact, so bit-equal), against the JAX ops in ref
    mode."""
    rng = np.random.default_rng(9)
    tdt = getattr(torch, dtype)

    def pair(*shape):
        a = rng.standard_normal(shape).astype(np.float32)
        t = torch.from_numpy(a).to(tdt)
        return jnp.asarray(t.float().numpy()).astype(dtype), t
    jq, tq = pair(1, 4, 64)
    jk, tk = pair(1, 256, 2, 64)
    jv, tv = pair(1, 256, 2, 64)
    cfg = JConfig(2, 1)
    want = jgen.decode_attn_gen(jq, jk, jv, config=cfg, mode="ref")
    got = tgen.decode_attn_gen(tq, tk, tv, config=_tcfg(cfg))
    tol = 2e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    jx, tx = pair(2, 16, 256)
    jw, tw = pair(256)
    want = jgen.rmsnorm_gen(jx, jw, config=cfg, mode="ref")
    got = tgen.rmsnorm_gen(tx, tw, config=_tcfg(cfg))
    assert tuple(got.shape) == (2, 16, 256) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    ja, ta = pair(48, 256)
    got = tgen.transpose_gen(ta, config=_tcfg(cfg))
    want = jgen.transpose_gen(ja, config=cfg, mode="ref")
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    mx, sm = tgen.rowstat_gen(ta, config=_tcfg(cfg))
    jmx, jsm = jgen.rowstat_gen(ja, config=cfg, mode="ref")
    np.testing.assert_array_equal(mx.numpy(), np.asarray(jmx))
    np.testing.assert_allclose(sm.numpy(), np.asarray(jsm), rtol=1e-5,
                               atol=1e-4)


def test_mxv1_sum_returns_a_scalar_total():
    """``gemver_mxv1_sum_gen`` returns (x + s + z, total) with a 0-d f32
    total, as the JAX op."""
    rng = np.random.default_rng(4)
    a, y, x, z = (rng.standard_normal(s).astype(np.float32)
                  for s in ((48, 256), (48,), (256,), (256,)))
    jout = jgen.gemver_mxv1_sum_gen(*(jnp.asarray(t) for t in (a, y, x, z)),
                                    1.2, config=JConfig(4, 2), mode="ref")
    tout = tgen.gemver_mxv1_sum_gen(*(torch.from_numpy(t)
                                      for t in (a, y, x, z)), 1.2,
                                    config=TConfig(4, 2))
    assert tout[1].shape == () and tout[1].dtype == torch.float32
    for g, w in zip(tout, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
