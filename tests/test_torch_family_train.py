"""Training every non-dense family in the port against the JAX package,
at ``reduced()`` size on carried f32 weights: qwen3-moe and arctic
(MoE, Arctic's dense residual), mamba2 (SSD), jamba (Mamba-2 / attention
periods with MoE), internvl2 (VLM prefix embeds) and whisper (the
encoder-decoder).

Covered: the loss and every gradient against ``jax.value_and_grad`` of
the JAX ``model.loss`` (with activation checkpointing, as both train
steps run it); two AdamW steps of ``make_train_step`` against the JAX
``make_train_step``; the repairs the wider path needed, each against
the JAX package: microbatches that split every leaf of the batch (R1,
``grad_accum=2``), the launcher's zero ``prefix_embeds`` and ``frames``
(R2), and the weight-decay mask over Whisper's encoder stack (R3); the
launcher training each family on the CPU; the kernel calls a step
makes; and checkpoints of MoE, Mamba-2 and Whisper train states
crossing between the packages.

Tolerances: the loss to 1e-5 relative in f32; each gradient to 1e-4 of
its tensor's largest entry (sums taken in another order); in bf16 the
limits stated at the test.  Parameters after AdamW steps as
``tests/test_torch_train.py``'s ``_params_close`` (an update is about lr
an entry, so its limit is absolute in units of lr).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.models.lm import build_model as jbuild_model
from repro.train import optimizer as jopt
from repro.train import trainstep as jtrainstep
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.kernels.adamw import ops as taops
from repro_torch.kernels.rmsnorm import ops as trops
from repro_torch.launch import steps
from repro_torch.models import blocks
from repro_torch.models.lm import build_model, params_from_numpy
from repro_torch.train import optimizer as topt
from repro_torch.train import trainstep as ttrainstep

ARCHS = ["qwen3-moe-30b-a3b", "arctic-480b", "mamba2-2.7b",
         "jamba-1.5-large-398b", "internvl2-2b", "whisper-medium"]
# the families whose batch holds a frontend stub's output beside tokens
WITH_STUB = ["internvl2-2b", "whisper-medium"]
STEP_CFG = dict(lr=3e-3, warmup_steps=1, total_steps=4, weight_decay=0.1)
B, S = 4, 17          # 16 labels a row; grad_accum=2 halves B


@pytest.fixture(autouse=True)
def _jax_ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")


def _cfgs(arch, compute_dtype="float32"):
    return (dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)),
                                compute_dtype=compute_dtype),
            dataclasses.replace(configs.reduced(configs.get_config(arch)),
                                compute_dtype=compute_dtype))


@functools.lru_cache(maxsize=None)
def _jax(arch, compute_dtype="float32", seed=0):
    """(JAX model, its params as numpy), made once per module run."""
    jcfg, _ = _cfgs(arch, compute_dtype)
    jmodel = jbuild_model(jcfg)
    tree = jax.tree.map(np.asarray,
                        jax.jit(jmodel.init)(jax.random.PRNGKey(seed)))
    return jmodel, tree


def _carried(arch, compute_dtype="float32", seed=0):
    """(JAX model, JAX params, port model, fresh trainable port params on
    the CPU) of the same f32 weights."""
    jmodel, tree = _jax(arch, compute_dtype, seed)
    _, tcfg = _cfgs(arch, compute_dtype)
    return (jmodel, jax.tree.map(jnp.asarray, tree), build_model(tcfg),
            params_from_numpy(tcfg, tree, device="cpu", trainable=True))


def _batch(cfg, b, s, seed):
    """numpy {tokens [B, S] int32; a VLM's prefix_embeds [B, Np, D] and
    Whisper's frames [B, enc_seq, D], f32}."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = rng.standard_normal(
            (b, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.encdec:
        out["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jleaf_of(tree, name, cfg):
    """The JAX tree's leaf of the port parameter ``name``: layer ``l`` of
    ``blocks`` is period ``l // P`` of ``pos{l % P}``, of ``enc_blocks``
    entry ``l`` of ``pos0``."""
    parts = name.split(".")
    if parts[0] not in ("blocks", "enc_blocks"):
        return tree[name]
    period = (len(blocks.layer_descriptors(cfg)) if parts[0] == "blocks"
              else 1)
    layer = int(parts[1])
    node = tree[parts[0]][f"pos{layer % period}"]
    for k in parts[2:]:
        node = node[k]
    return node[layer // period]


def _named(tree, names, cfg) -> dict:
    return {n: np.asarray(_jleaf_of(tree, n, cfg), np.float32)
            for n in names}


def _params_close(got: dict, want: dict, lr: float):
    """As ``tests/test_torch_train.py``'s, 1e-3 lr for all but 0.1% of the
    entries of each tensor (but one, in a tensor of under 1000 entries:
    jamba's [64] norm gains), with every entry within 0.1 lr where the
    dense test holds 5e-2 lr: the first AdamW update of an entry is
    lr · g / (|g| + eps) with eps 1e-8, so where the clipped gradient is
    about eps the update swings with g's last bits.  Reduced jamba has
    such entries (g 5e-10 to 2e-7 before a clip scale of 0.11) and
    reaches 0.078 lr on one of 8192 entries of blocks.2.ffn.w_out."""
    for name, p in got.items():
        d = np.abs(p.detach().float().numpy() - np.asarray(want[name]))
        assert d.max() <= 0.1 * lr, (name, d.max() / lr)
        assert (d > 1e-3 * lr).sum() <= max(1, 1e-3 * d.size), name


def _port_state(tparams):
    return {"params": tparams, "opt_state": topt.adamw_init(
        dict(tparams.named_parameters()))}


# ------------------------------------------------------ loss and grads

# bf16 activations round at other points in the two packages' forward
# and backward: each gradient to 5% of its largest entry, as the dense
# test's (tests/test_torch_train.py).  Mamba-2 to 10%: the gradients of
# its f32 dt_bias, a_log and d_skip sum a term of every token and head,
# each a product of bf16-rounded activations through softplus and exp
# (dt_bias reaches 7.3%, its f32 case 1e-4).  Not with a MoE router,
# whose near-ties pick other experts under bf16 rounding
# (tests/test_torch_families.py): f32 holds those archs.
GRAD_CASES = ([(a, "float32", 1e-4) for a in ARCHS]
              + [("mamba2-2.7b", "bfloat16", 0.1)]
              + [(a, "bfloat16", 5e-2) for a in WITH_STUB])


@pytest.mark.parametrize("arch,compute_dtype,gtol", GRAD_CASES)
def test_loss_and_grads_match_jax(arch, compute_dtype, gtol):
    """``loss`` and ``torch.autograd.grad`` of it under activation
    checkpointing (MoE routing recomputed in the backward, Mamba-2's f32
    dt_bias / a_log / d_skip, the prefix embeds, Whisper's encoder and
    cross-attention) against ``jax.value_and_grad`` of the JAX loss."""
    jmodel, jparams, tmodel, tparams = _carried(arch, compute_dtype)
    cfg = tmodel.cfg
    batch = _batch(cfg, 2, S, seed=1)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b), has_aux=True))(jparams, _j(batch))
    tl, tm = tmodel.loss(tparams, _t(batch))
    named = dict(tparams.named_parameters())
    tg = torch.autograd.grad(tl, list(named.values()))
    ltol = 1e-5 if compute_dtype == "float32" else 2e-3
    for got, want in ((tl, jl), (tm["nll"], jm["nll"]),
                      (tm["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=ltol,
                                   atol=ltol)
    want = _named(jg, named, cfg)
    for (name, p), g in zip(named.items(), tg):
        assert g.dtype == p.dtype == torch.float32, name
        w = want[name]
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= gtol * scale, (name, err, scale)
    # every parameter takes part in the loss
    assert all(float(g.abs().max()) > 0 for g in tg)


def test_ssd_gradient_stays_finite_where_exp_overflows():
    """Found training Mamba2-2.7B at its published widths on the card
    (grad norm NaN at step 0): above the chunk's diagonal ``seg`` (a sum
    of -A·dt) overflows exp to inf, and ``where(causal, exp(seg), 0)``
    then has the masked gradient 0 · inf = NaN in eager PyTorch (XLA
    folds the JAX package's same expression into a finite one).  The
    port masks ``seg`` before exp.  Here A = -1e5 makes the reduced
    model overflow: the loss and every gradient match JAX's, all
    finite."""
    jmodel, tree = _jax("mamba2-2.7b")
    _, tcfg = _cfgs("mamba2-2.7b")
    tree = jax.tree.map(np.copy, tree)
    tree["blocks"]["pos0"]["mamba"]["a_log"][:] = np.log(1e5)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tcfg, tree, device="cpu", trainable=True)
    batch = _batch(tcfg, 2, S, seed=6)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss(p, b), has_aux=True))(jparams, _j(batch))
    tl, _ = build_model(tcfg).loss(tparams, _t(batch))
    named = dict(tparams.named_parameters())
    tg = torch.autograd.grad(tl, list(named.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    want = _named(jg, named, tcfg)
    for (name, _), g in zip(named.items(), tg):
        assert bool(torch.isfinite(g).all()), name
        scale = float(np.abs(want[name]).max())
        assert float(np.abs(g.numpy() - want[name]).max()) <= 1e-4 * scale
    # the unmasked form's gradient in eager PyTorch
    seg = torch.tensor([[0.0, 1e4]], requires_grad=True)
    keep = torch.tensor([[True, False]])
    torch.where(keep, torch.exp(seg), 0.0).sum().backward()
    assert bool(torch.isnan(seg.grad).any())


def test_moe_routing_is_recomputed_alike_under_remat():
    """The checkpointed MoE layer's backward recomputes its forward: the
    stable routing sort and the host read of the counts give the same
    picks, so remat and no remat give equal gradients."""
    _, _, tmodel, tparams = _carried("qwen3-moe-30b-a3b")
    batch = _t(_batch(tmodel.cfg, 2, S, seed=2))
    grads = []
    for remat in (True, False):
        loss, _ = tmodel.loss(tparams, batch, remat=remat)
        grads.append(torch.autograd.grad(loss, list(tparams.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------- train steps

@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_jax(arch):
    """Two steps of ``make_train_step`` (AdamW at weight decay 0.1, f32)
    against the JAX train step on the same weights and batches: each
    step's metrics and every parameter after the second."""
    jmodel, jparams, tmodel, tparams = _carried(arch, seed=1)
    cfg = tmodel.cfg
    ocfg = STEP_CFG
    jstep = jax.jit(jtrainstep.make_train_step(jmodel, jopt.AdamWConfig(
        **ocfg)))
    tstep = ttrainstep.make_train_step(tmodel, topt.AdamWConfig(**ocfg))
    jstate = {"params": jparams, "opt_state": jopt.adamw_init(jparams)}
    tstate = _port_state(tparams)
    for step in range(2):
        batch = _batch(cfg, B, S, seed=20 + step)
        jstate, jm = jstep(jstate, _j(batch))
        tstate, tm = tstep(tstate, _t(batch))
        assert set(tm) == set(jm) == {"loss", "nll", "aux", "lr",
                                      "grad_norm"}
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    named = dict(tstate["params"].named_parameters())
    _params_close(named, _named(jstate["params"], named, cfg), ocfg["lr"])
    assert int(tstate["opt_state"]["step"]) == 2


@pytest.mark.parametrize("arch", WITH_STUB)
def test_grad_accum_splits_every_leaf_of_the_batch(arch):
    """R1: ``grad_accum=2`` splits the prefix embeds or frames with the
    tokens, as the JAX package splits every leaf: the same step as one
    batch (equal token counts), and the JAX ``grad_accum=2`` step."""
    jmodel, jparams, tmodel, tparams = _carried(arch, seed=2)
    _, _, _, tparams1 = _carried(arch, seed=2)
    cfg, ocfg = tmodel.cfg, STEP_CFG
    batch = _batch(cfg, B, S, seed=30)
    jstate = {"params": jparams, "opt_state": jopt.adamw_init(jparams)}
    jstate, jm = jax.jit(jtrainstep.make_train_step(
        jmodel, jopt.AdamWConfig(**ocfg), grad_accum=2))(jstate, _j(batch))
    s2, m2 = ttrainstep.make_train_step(
        tmodel, topt.AdamWConfig(**ocfg), grad_accum=2)(
            _port_state(tparams), _t(batch))
    s1, m1 = ttrainstep.make_train_step(tmodel, topt.AdamWConfig(**ocfg))(
        _port_state(tparams1), _t(batch))
    assert set(m2) == set(jm) == {"loss", "lr", "grad_norm"}
    for k in jm:
        np.testing.assert_allclose(float(m2[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    p2 = dict(s2["params"].named_parameters())
    _params_close(p2, _named(jstate["params"], p2, cfg), ocfg["lr"])
    _params_close(p2, {k: p.detach().numpy() for k, p in
                       s1["params"].named_parameters()}, ocfg["lr"])


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_decay_mask_matches_jax(arch):
    """R3: the port decays a parameter exactly where the JAX package
    decays its leaf (ndim >= 2 of the stacked tree): every tensor of
    ``blocks`` and of Whisper's ``enc_blocks`` (norm gains and Mamba-2's
    [H] scalars included), embed and head; not final_norm or enc_norm."""
    _, tree = _jax(arch)
    tparams, cfg = _carried(arch)[3], _cfgs(arch)[1]
    for name, p in tparams.named_parameters():
        want = np.asarray(_jleaf_of(tree, name, cfg))
        stacked = name.split(".")[0] in ("blocks", "enc_blocks")
        j_ndim = want.ndim + (1 if stacked else 0)
        assert topt.decays(name, p) == (j_ndim >= 2), name
    names = [n for n, _ in tparams.named_parameters()]
    assert not topt.decays("final_norm", tparams.final_norm)
    if cfg.encdec:
        assert not topt.decays("enc_norm", tparams.enc_norm)
        assert topt.decays("enc_blocks.0.norm1",
                           tparams.enc_blocks[0].norm1)
        assert "enc_blocks.1.norm2" in names


@pytest.mark.parametrize("arch", ARCHS)
def test_each_step_runs_the_kernel_calls_the_chip_counts(arch,
                                                         monkeypatch):
    """The calls a step makes to the two kernel ops, on the CPU: rmsnorm
    for each layer's norms (norm1, norm_x where it cross-attends, norm2
    where it has an FFN, Mamba-2's gated norm) twice, once forward and
    once as remat recomputes the layer, plus the final norm and
    Whisper's enc_norm once; adamw_update once per parameter tensor."""
    _, _, tmodel, tparams = _carried(arch, seed=3)
    cfg = tmodel.cfg
    calls = {"rmsnorm": 0, "adamw_update": 0}

    def count(mod, name):
        real = getattr(mod, name)

        def spy(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    count(trops, "rmsnorm")
    count(taops, "adamw_update")
    step = ttrainstep.make_train_step(tmodel, topt.AdamWConfig())
    step(_port_state(tparams), _t(_batch(cfg, 2, 9, seed=4)))
    layers = list(tparams.blocks) + list(getattr(tparams, "enc_blocks", []))
    per_layer = sum(1 + (layer.desc.ffn != "none") + layer.desc.cross
                    + (layer.desc.mixer == "mamba") for layer in layers)
    assert calls == {
        "rmsnorm": 2 * per_layer + 1 + cfg.encdec,
        "adamw_update": len(list(tparams.parameters()))}


# ------------------------------------------------------------- launcher

@pytest.mark.parametrize("arch", WITH_STUB)
def test_launcher_batch_holds_the_frontend_stubs(arch, tmp_path,
                                                 monkeypatch):
    """R2: the launcher's batch holds zero ``prefix_embeds`` for a VLM and
    zero ``frames`` for Whisper beside the pipeline's tokens, as the JAX
    launcher builds it, with ``abstract_batch``'s shapes and dtypes."""
    from repro_torch.launch import train
    seen = []
    real = train.make_train_step

    def spy(*a, **kw):
        step = real(*a, **kw)

        def wrapped(state, batch):
            seen.append({k: v.clone() for k, v in batch.items()})
            return step(state, batch)
        return wrapped
    monkeypatch.setattr(train, "make_train_step", spy)
    train.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                "--batch", "2", "--seq", "8", "--ckpt-dir",
                str(tmp_path)])
    cfg = configs.reduced(configs.get_config(arch))
    shape = dataclasses.replace(configs.get_shape("train_4k"),
                                global_batch=2, seq_len=8)
    want = steps.abstract_batch(cfg, shape)
    assert len(seen) == 2
    for batch in seen:
        assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == {
            k: (tuple(v.shape), v.dtype) for k, v in want.items()}
        stub = "frames" if cfg.encdec else "prefix_embeds"
        assert not batch[stub].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_the_family_on_cpu(arch, tmp_path, capsys):
    """``launch.train.main`` trains each family through the checkpoint
    and resumes from it."""
    from repro_torch.launch import train
    ck = str(tmp_path / "ck")
    state = train.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                        "--batch", "2", "--seq", "8", "--log-every", "1",
                        "--ckpt-dir", ck])
    out = capsys.readouterr().out
    assert out.count("loss") == 2 and "done; checkpoints: [2]" in out
    assert "nan" not in out
    assert int(state["opt_state"]["step"]) == 2
    state = train.main(["--arch", arch, "--device", "cpu", "--steps", "3",
                        "--batch", "2", "--seq", "8", "--ckpt-dir", ck,
                        "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert int(state["opt_state"]["step"]) == 3


def test_build_train_step_runs_each_family_on_cpu():
    """``steps.build_train_step`` gives each family its batch keys and
    a step that runs."""
    for arch in ARCHS:
        cfg = configs.reduced(configs.get_config(arch))
        shape = dataclasses.replace(configs.get_shape("train_4k"),
                                    global_batch=2, seq_len=8)
        step, (state, batch) = steps.build_train_step(cfg, shape,
                                                      device="cpu")
        assert set(batch) == set(steps.abstract_batch(cfg, shape)), arch
        _, metrics = step(state, batch)
        assert np.isfinite(float(metrics["loss"])), arch


# ----------------------------------------------------------- checkpoints

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


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-2.7b",
                                  "whisper-medium"])
def test_checkpoints_cross_between_the_packages(arch, tmp_path):
    """A trained MoE, Mamba-2 or Whisper state written by the port
    restores through the JAX ``CheckpointManager`` and back into a fresh
    port state, bit-equal (the Mamba-2 f32 scalars and Whisper's
    ``enc_blocks`` / ``enc_norm`` included); the JAX package's own train
    state of the same model restores through the port's manager with
    every leaf of the JAX tree."""
    jmodel, jparams, tmodel, tparams = _carried(arch, seed=4)
    state = _port_state(tparams)
    step = ttrainstep.make_train_step(tmodel, topt.AdamWConfig())
    state, _ = step(state, _t(_batch(tmodel.cfg, 2, 9, seed=5)))
    tree = ttrainstep.state_tree(state)
    mgr = CheckpointManager(str(tmp_path / "port"), keep=2)
    mgr.save(1, tree)
    mgr.wait()
    jstep, jtree = JCheckpointManager(str(tmp_path / "port")).restore()
    assert jstep == 1
    _tree_equal(jtree, tree)
    fresh = _port_state(_carried(arch, seed=5)[3])
    _, back = mgr.restore(device="cpu")
    ttrainstep.load_state_tree(fresh, back)
    _tree_equal(ttrainstep.state_tree(fresh), tree)

    jstate = {"params": jparams, "opt_state": jopt.adamw_init(jparams)}
    jm = JCheckpointManager(str(tmp_path / "jax"), async_save=False)
    jm.save(3, jstate)
    s, got = CheckpointManager(str(tmp_path / "jax")).restore(device="cpu")
    assert s == 3
    _tree_equal(got, jax.tree.map(np.asarray, jstate))
