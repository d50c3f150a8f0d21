"""The port's sharding rules (``repro_torch.sharding.rules``), its shards
(``sharding.layout``), the name ↔ path map (``models.lm.param_paths``)
and ``runtime.elastic.plan_mesh`` against the JAX package's.

The rules run on both packages' abstract trees of every arch at its
published widths (no weight is allocated: JAX's ``eval_shape``, the
port's meta tensors), on stub meshes (``axis_names`` and ``shape``) at
the production 16×16 and 2×16×16 and at data=2, data=4 and
pod=2,data=2 (each with a model axis of 1, which the JAX rules read).
The port's specs are the JAX ones without the stacked lead None.
"""
import dataclasses
import functools
import itertools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models.lm import build_model as jbuild_model
from repro.runtime import elastic as jelastic
from repro.sharding import rules as jrules
from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.models.lm import build_model, param_paths, params_from_numpy
from repro_torch.runtime import plan_mesh
from repro_torch.sharding import rules
from repro_torch.sharding.layout import Shard, shard_of, shard_tree


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.sizes))


MESHES = {
    "16x16": Mesh(("data", "model"), (16, 16)),
    "2x16x16": Mesh(("pod", "data", "model"), (2, 16, 16)),
    "data=2": Mesh(("data", "model"), (2, 1)),
    "data=4": Mesh(("data", "model"), (4, 1)),
    "pod=2,data=2": Mesh(("pod", "data", "model"), (2, 2, 1)),
}


def _spec(p) -> tuple:
    return tuple(p)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jsteps.abstract_params(jbuild_model(jconfigs.get_config(arch)))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("serving", [False, True], ids=["train", "serve"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_param_specs_match_jax(arch, mesh, serving):
    cfg = configs.get_config(arch)
    jspecs = jrules.param_specs(_jax_params(arch), jconfigs.get_config(arch),
                                MESHES[mesh], serving=serving)
    got = rules.param_specs(build_model(cfg).init(device="meta"), cfg,
                            MESHES[mesh], serving=serving)
    paths = param_paths(cfg)
    assert set(got) == set(paths)
    for name, spec in got.items():
        path, i = paths[name]
        want = _spec(_at(jspecs, path))
        if i is not None:            # a stacked leaf: drop the lead None
            assert want[0] is None, name
            want = want[1:]
        assert spec == want, (name, spec, want)


CELLS = jconfigs.cells()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_specs_match_jax(arch, shape, mesh):
    jcfg, jshape = jconfigs.get_config(arch), jconfigs.get_shape(shape)
    cfg, shp = configs.get_config(arch), configs.get_shape(shape)
    for for_decode in (False, True):
        want = jrules.batch_specs(jsteps.abstract_batch(jcfg, jshape,
                                                        for_decode),
                                  jcfg, MESHES[mesh], jshape)
        got = rules.batch_specs(steps.abstract_batch(cfg, shp, for_decode),
                                cfg, MESHES[mesh], shp)
        assert got == {k: _spec(v) for k, v in want.items()}


@functools.lru_cache(maxsize=None)
def _jax_cache(arch, shape):
    jcfg = jconfigs.get_config(arch)
    return jsteps.abstract_cache(jbuild_model(jcfg), jcfg,
                                 jconfigs.get_shape(shape))


def _layer_cache_specs(jspecs, cfg, kind):
    """The JAX cache specs of each layer of the port's list, lead dropped:
    layer l is index l // P of ``pos{l % P}``."""
    from repro_torch.models.blocks import layer_descriptors
    descs = layer_descriptors(cfg)
    out = []
    for layer in range(cfg.n_layers):
        pos = jspecs[f"pos{layer % len(descs)}"]
        node = pos[kind] if kind else pos
        node = node.get("attn", node.get("mamba", node))
        out.append({k: _spec(v)[1:] for k, v in node.items()})
    for layer in out:
        for spec in layer.values():
            assert spec is not None
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", [c for c in CELLS
                                        if c[1] != "train_4k"])
def test_cache_specs_match_jax(arch, shape, mesh):
    jcfg, jshape = jconfigs.get_config(arch), jconfigs.get_shape(shape)
    cfg, shp = configs.get_config(arch), configs.get_shape(shape)
    jcache = _jax_cache(arch, shape)
    cache = steps.abstract_cache(build_model(cfg), cfg, shp)
    m = MESHES[mesh]
    got = steps._decode_cache_specs(cache, cfg, m, shp)
    want = jsteps._decode_cache_specs(jcache, jcfg, m, jshape)
    if cfg.encdec:
        assert got["self"] == _layer_cache_specs(want["self"], cfg, None)
        assert got["cross"] == _layer_cache_specs(want["cross"], cfg, None)
    else:
        assert got == _layer_cache_specs(want, cfg, None)


def test_rules_treat_a_missing_axis_as_one():
    """``data=4`` alone is the mesh ``data=4,model=1`` to the port (the
    JAX rules need a model axis)."""
    cfg = configs.get_config("yi-9b")
    meta = build_model(cfg).init(device="meta")
    alone = Mesh(("data",), (4,))
    assert rules.param_specs(meta, cfg, alone) == \
        rules.param_specs(meta, cfg, MESHES["data=4"])
    assert rules.mesh_shape(alone) == {"data": 4}


def test_p_ax_and_mesh_axes_match_jax():
    for axes in ((), ("data",), ("pod", "data")):
        assert rules.P_ax(axes) == jrules.P_ax(axes)
    for m in MESHES.values():
        assert dataclasses.asdict(rules.MeshAxes.for_mesh(m)) == \
            dataclasses.asdict(jrules.MeshAxes.for_mesh(m))
        assert rules.MeshAxes.for_mesh(m).batch == \
            jrules.MeshAxes.for_mesh(m).batch


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_param_paths_carry_every_leaf(arch):
    """The name ↔ path map: every port parameter is the JAX init tree's
    leaf at its path (its layer's index of a stacked leaf), and every
    JAX leaf is some parameter (each layer of a stacked one)."""
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    cfg = configs.reduced(configs.get_config(arch))
    tree = jax.tree.map(np.asarray,
                        jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
    params = dict(params_from_numpy(cfg, tree, device="cpu",
                                    trainable=True).named_parameters())
    paths = param_paths(cfg)
    assert set(params) == set(paths)
    seen = {}
    for name, (path, i) in paths.items():
        leaf = _at(tree, path)
        want = leaf if i is None else leaf[i]
        np.testing.assert_array_equal(params[name].detach().numpy(), want)
        seen.setdefault(path, set()).add(i)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert {tuple(k.key for k in p) for p, _ in flat} == set(seen)
    for (p, leaf) in flat:
        idx = seen[tuple(k.key for k in p)]
        if idx != {None}:
            assert idx == set(range(leaf.shape[0]))


# ----------------------------------------------------------------- shards

@pytest.mark.parametrize("n,size", [(2, 8), (4, 8), (4, 130), (4, 5), (3, 7)])
@pytest.mark.parametrize("dim", [0, 1])
def test_shards_cover_a_dim_once_and_pad_as_gspmd(n, size, dim):
    """Pieces of ceil(D / n) at r · ceil(D / n), zero past D; placed back
    in rank order they give the leaf."""
    shape = (size, 3) if dim == 0 else (3, size)
    t = torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape)
    spec = ("data", None) if dim == 0 else (None, "data")
    mesh = Mesh(("data", "model"), (n, 1))
    c = -(-size // n)
    pieces = [shard_of(shape, spec, mesh, {"data": r, "model": 0})
              for r in range(n)]
    whole = torch.full(shape, -1.0)
    for r, sh in enumerate(pieces):
        local = sh.local(t)
        assert local.is_contiguous()
        assert local.shape[dim] == c
        lo, hi = r * c, min(size, r * c + c)
        np.testing.assert_array_equal(
            local.narrow(dim, 0, max(hi - lo, 0)).numpy(),
            t.narrow(dim, min(lo, size), max(hi - lo, 0)).numpy())
        assert not local.narrow(dim, max(hi - lo, 0),
                                c - max(hi - lo, 0)).any()
        sh._place(whole, local)
    np.testing.assert_array_equal(whole.numpy(), t.numpy())


def test_shards_of_two_axes_index_row_major():
    """A dim over ("pod", "data") is cut pod-outermost, as GSPMD does."""
    mesh = Mesh(("pod", "data", "model"), (2, 2, 1))
    t = torch.arange(8.0)
    got = [shard_of((8,), (("pod", "data"),), mesh,
                    {"pod": p, "data": d, "model": 0}).local(t).tolist()
           for p, d in itertools.product(range(2), range(2))]
    assert got == [[0, 1], [2, 3], [4, 5], [6, 7]]


@pytest.mark.parametrize("mesh", ["data=2", "data=4", "pod=2,data=2",
                                  "16x16"])
def test_shard_tree_on_meta_gives_per_rank_bytes(mesh):
    """Yi-9B's training state at its published widths, cut on meta: the
    per-rank bytes without allocating, every sharded leaf's piece
    ceil(D / n) along its cut dim, the whole ones untouched."""
    cfg = configs.get_config("yi-9b")
    model = build_model(cfg)
    state = steps.abstract_state(model)
    m = MESHES[mesh]
    specs = steps.state_specs(state, cfg, m)
    named = dict(state["params"].named_parameters())
    local = shard_tree(named, specs["params"], m)
    sizes = rules.mesh_shape(m)
    for k, t in local.items():
        assert t.device.type == "meta"
        want = list(named[k].shape)
        for d, entry in enumerate(specs["params"][k]):
            axes = entry if isinstance(entry, tuple) else (entry,)
            n = int(np.prod([sizes[a] for a in axes if a]))
            want[d] = -(-want[d] // n)
        assert list(t.shape) == want, k
    whole = steps.tree_bytes(named)
    per_rank = steps.tree_bytes(local)
    # at model=1 only the layers' matrices are cut (over data; Yi-9B's
    # dims divide by 4); at 16x16 the embedding and head over model too
    cut = sum(steps.tree_bytes(t) for k, t in named.items()
              if "data" in specs["params"][k])
    assert cut > 0.9 * whole
    if mesh != "16x16":
        assert per_rank == whole - cut + cut // sizes["data"]
    assert per_rank < whole


# ---------------------------------------------------------------- elastic

GRID = [(n, mp, pods) for n in (0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64, 256,
                                512)
        for mp in (1, 2, 4, 16) for pods in (1, 2)]


@pytest.mark.parametrize("n,mp,pods", GRID)
def test_plan_mesh_matches_jax(n, mp, pods):
    try:
        want = jelastic.plan_mesh(n, mp, pods)
    except ValueError as err:
        with pytest.raises(ValueError, match="cannot host"):
            plan_mesh(n, mp, pods)
        assert "cannot host" in str(err)
        return
    assert plan_mesh(n, mp, pods) == want


def test_plan_mesh_cases_of_the_jax_tests():
    """``tests/test_runtime.py``'s cases: node loss shrinks data, an
    indivisible count halves TP, two pods, and the refusal."""
    assert plan_mesh(64, model_parallel=16) == ((4, 16), ("data", "model"))
    assert plan_mesh(32, model_parallel=16) == ((2, 16), ("data", "model"))
    assert plan_mesh(24, model_parallel=16) == ((3, 8), ("data", "model"))
    assert plan_mesh(64, model_parallel=16, pods=2) == (
        (2, 2, 16), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="cannot host"):
        plan_mesh(0, model_parallel=16)


def test_shard_on_refuses_another_shape():
    sh = Shard.of((4, 4), ("data", None), {"data": 2}, {"data": 0})
    assert sh.on((4, 4)) is sh
    with pytest.raises(ValueError):
        sh.on((4, 5))
