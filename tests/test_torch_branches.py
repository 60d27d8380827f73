"""The four other branch families and their building blocks against JAX, on the CPU.

Each port module is filled from the JAX module's variables through the weight
bridge (`checkpoint/from_jax.py`) and given the same numpy inputs, fp32,
dropout off: `MLPLayers`; `TransformerEncoder` post- and pre-norm, at 4 heads
and at one; `kw_bn_fixed` in its four layouts, in training and in eval;
`ParallelBranch`, `CascadedBranch` (one head, as the base configs set it),
`HybridBranch` (with its MLP projections) and `CascadedBranchPlus`, each in
training form (keyword-BN batch statistics, CIF scaling, straight-through VQ)
with the gradients of every parameter, `extract_hidden_states` on all five
branches and `CascadedBranch.get_attention_map`.

Tolerances: values 1e-5 abs; gradients 1e-5 abs + 1e-4 rel + 1e-4 of the
tensor set's largest gradient entry (fp32 on both sides, sums in another
order; entries that are zero in exact arithmetic hold rounding noise of that
size); VQ targets and keyword counts equal. The JAX branch attention takes its
XLA path on the CPU; the port runs the plain twins of K1, K2, K3 and K3b.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.models import branches as jb
from speechclip_plus_tpu.models.cif import CifConfig as JCifConfig
from speechclip_plus_tpu.nn.mlp import MLPLayers as JMLPLayers
from speechclip_plus_tpu.nn.transformer import TransformerEncoder as JTransformerEncoder
from speechclip_plus_tpu.ops import kw_bn as jkw_bn

from speechclip_plus_tpu_torch.checkpoint import from_jax
from speechclip_plus_tpu_torch.models import branches as pb
from speechclip_plus_tpu_torch.models.cif import CifConfig
from speechclip_plus_tpu_torch.nn.mlp import MLPLayers
from speechclip_plus_tpu_torch.nn.transformer import TransformerEncoder
from speechclip_plus_tpu_torch.ops import kw_bn

ATOL = 1e-5
D, V, W = 32, 40, 24  # branch width, vocabulary, text width


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map(lambda a: a, dict(tree)))


def _fill(module, fill, params, stats=None):
    """Fill a port module from JAX params with one of the bridge's fillers,
    strictly: every tensor filled, every leaf read."""
    f, p = from_jax._Filler(module), from_jax._Tree(params, "params")
    s = from_jax._Tree(stats or {}, "batch_stats")
    fill(f, module, p, s) if stats is not None else fill(f, module, p)
    from_jax._finish(f, p, s)
    return module


def _check_grads(module, make, fill, jgrads, stats=None):
    """The port module's .grad fields against JAX gradients, moved into the
    port's layout through the same bridge."""
    holder = _fill(make(), fill, jgrads, stats)
    want = dict(holder.named_parameters())
    gmax = max(float(p.detach().abs().max()) for p in want.values())
    assert gmax > 0
    for n, p in module.named_parameters():
        assert p.grad is not None, n
        np.testing.assert_allclose(p.grad.numpy(), want[n].detach().numpy(), rtol=1e-4,
                                   atol=ATOL + 1e-4 * gmax, err_msg=f"gradient {n}")


def _inputs(seed, b=3, t=21):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, D).astype(np.float32)
    lens = np.array([t] + list(rng.randint(t // 2, t, size=b - 1)))
    return x, lens, rng


def test_mlp_layers_match_jax():
    units = (D, 48, 40, W)
    x, _, rng = _inputs(0)
    probe = rng.randn(3, 21, W).astype(np.float32)
    jm = JMLPLayers(units=units)
    params = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    jout, jgrads = jax.value_and_grad(
        lambda p: (jm.apply({"params": p}, jnp.asarray(x)) * probe).sum())(params)
    make = lambda: MLPLayers(units)
    mod = _fill(make(), from_jax._fill_mlp, params)
    out = mod(torch.from_numpy(x))
    assert len(mod.layers) == 3 and out.shape == (3, 21, W)
    (out * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(float((out.detach() * torch.from_numpy(probe)).sum()), float(jout),
                               rtol=1e-5)
    _check_grads(mod, make, from_jax._fill_mlp, _np(jgrads))
    # a generator turns the hidden dropouts on; none leaves them off
    assert torch.equal(mod(torch.from_numpy(x)), out)
    assert not torch.equal(mod(torch.from_numpy(x), torch.Generator().manual_seed(0)), out)


@pytest.mark.parametrize("norm_first", [False, True])
@pytest.mark.parametrize("nhead,n_layers", [(4, 2), (1, 1)])
def test_transformer_encoder_matches_jax(norm_first, nhead, n_layers):
    x, lens, rng = _inputs(1)
    mask = np.arange(21)[None, :] >= lens[:, None]
    probe = rng.randn(3, 21, D).astype(np.float32)
    kw = dict(n_layers=n_layers, d_model=D, nhead=nhead, dim_feedforward=64,
              norm_first=norm_first)
    jm = JTransformerEncoder(**kw)
    params = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask)))["params"]
    jrun = lambda p: jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask))
    jgrads = jax.grad(lambda p: (jrun(p) * probe).sum())(params)
    make = lambda: TransformerEncoder(**kw)
    mod = _fill(make(), from_jax._fill_self_att, params)
    out = mod(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jrun(params)), atol=ATOL, rtol=0)
    (out * torch.from_numpy(probe)).sum().backward()
    _check_grads(mod, make, from_jax._fill_self_att, _np(jgrads))
    hs = mod.extract_hidden_states(torch.from_numpy(x), torch.from_numpy(mask))
    jhs = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask),
                   method=JTransformerEncoder.extract_hidden_states)
    assert len(hs) == len(jhs) == n_layers + 1
    for a, b in zip(hs, jhs):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=ATOL, rtol=0)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("layout", ["eachKw_parallel", "eachKw", "same", "same_lens"])
def test_kw_bn_fixed_matches_jax(layout, training):
    b, k, d = 5, 4, 6
    rng = np.random.RandomState(2)
    x = rng.randn(b, k, d).astype(np.float32)
    shape = {"eachKw_parallel": (d * k,), "eachKw": (k, d)}.get(layout, (d,))
    scale, bias = rng.rand(*shape).astype(np.float32) + 0.5, rng.randn(*shape).astype(np.float32)
    mean, var = rng.randn(*shape).astype(np.float32), rng.rand(*shape).astype(np.float32) + 0.5
    lens = np.array([4, 2, 3, 1, 4]) if layout == "same_lens" else None
    kw = dict(batchnorm_type="same" if layout.startswith("same") else "eachKw",
              parallel=layout == "eachKw_parallel", training=training)
    probe = rng.randn(b, k, d).astype(np.float32)

    def jrun(xj):
        y, st = jkw_bn.kw_bn_fixed(
            xj, {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
            {"mean": jnp.asarray(mean), "var": jnp.asarray(var)},
            seq_lens=None if lens is None else jnp.asarray(lens), **kw)
        return (y * probe).sum(), (y, st)

    (_, (jy, jst)), jdx = jax.value_and_grad(jrun, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, stats = kw_bn.kw_bn_fixed(
        xt, *(torch.from_numpy(a) for a in (scale, bias, mean, var)),
        seq_lens=None if lens is None else torch.from_numpy(lens), **kw)
    (y * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), atol=ATOL, rtol=1e-4)
    assert (stats is not None) == training
    if training:
        assert stats[0].shape == shape
        np.testing.assert_allclose(stats[0].numpy(), np.asarray(jst["mean"]), atol=ATOL, rtol=0)
        np.testing.assert_allclose(stats[1].numpy(), np.asarray(jst["var"]), atol=ATOL, rtol=0)


# ------------------------------------------------------------ branches ----

def _ta(kind, nhead, **kw):
    return dict(type=kind, n_layers=1, d_model=D, nhead=nhead, dim_feedforward=64, **kw)


def _heads(bn_type="eachKw", parallel=True, kw_proj=None, variant_k=4):
    j = jb.KeywordHeadConfig(
        d_model=D, text_dim=W, kw_proj_dims=kw_proj, keyword_num=variant_k,
        bn=jb.KwBnConfig(type=bn_type, parallel=parallel), vq=jb.VQConfig())
    p = pb.KeywordHeadConfig(
        d_model=D, text_dim=W, kw_proj_dims=kw_proj, keyword_num=variant_k,
        bn=pb.KwBnConfig(type=bn_type, parallel=parallel), vq=pb.VQConfig())
    return j, p


def _branch_pair(name):
    """(JAX module, port factory) of one branch at width 32."""
    if name == "parallel":
        ta = _ta("TransformerEncoder", 4)
        return (jb.ParallelBranch(ta=jb.TransformerArgs(**ta), out_dim=W),
                lambda: pb.ParallelBranch(pb.TransformerArgs(**ta), out_dim=W))
    if name == "parallel_noproj":
        ta = _ta("MultiheadAttentionAndNorm", 4)
        return (jb.ParallelBranch(ta=jb.TransformerArgs(**ta), out_dim=W, need_projection=False),
                lambda: pb.ParallelBranch(pb.TransformerArgs(**ta), out_dim=W,
                                          need_projection=False))
    if name == "cascaded":  # one head over the model width, fused eachKw BN
        ta, (jh, ph) = _ta("MultiheadAttentionAndNorm", 1), _heads()
        return (jb.CascadedBranch(ta=jb.TransformerArgs(**ta), head=jh),
                lambda: pb.CascadedBranch(pb.TransformerArgs(**ta), ph))
    if name == "cascaded_perkw":  # per-keyword BN, an MLP keyword projection
        ta = _ta("TransformerEncoder", 4, norm_first=True)
        jh, ph = _heads(parallel=False, kw_proj=(D, 40, W))
        return (jb.CascadedBranch(ta=jb.TransformerArgs(**ta), head=jh),
                lambda: pb.CascadedBranch(pb.TransformerArgs(**ta), ph))
    if name == "hybrid":
        ta, (jh, ph) = _ta("MultiheadAttentionAndNorm", 4), _heads()
        return (jb.HybridBranch(ta=jb.TransformerArgs(**ta), head=jh, out_dim=W),
                lambda: pb.HybridBranch(pb.TransformerArgs(**ta), ph, out_dim=W))
    if name == "hybrid_mlp":  # `projection_config` MLP, shared ("same") BN
        ta, (jh, ph) = _ta("MultiheadAttentionAndNorm", 4), _heads(bn_type="same")
        dims = (D, 48, W)
        return (jb.HybridBranch(ta=jb.TransformerArgs(**ta), head=jh, out_dim=W,
                                parallel_proj_dims=dims),
                lambda: pb.HybridBranch(pb.TransformerArgs(**ta), ph, out_dim=W,
                                        parallel_proj_dims=dims))
    if name == "cascaded_plus":
        ta, (jh, ph) = _ta("MultiheadAttentionAndNorm", 1), _heads()
        cif = dict(encoder_embed_dim=D, max_feat_len=14, scaling_step=5000,
                   quantity_loss_weight=0.25)
        return (jb.CascadedBranchPlus(ta=jb.TransformerArgs(**ta), head=jh,
                                      cif=JCifConfig(cif_output_dim=D, **cif)),
                lambda: pb.CascadedBranchPlus(pb.TransformerArgs(**ta), ph, CifConfig(**cif)))
    if name == "hybrid_plus":
        ta, (jh, ph) = _ta("MultiheadAttentionAndNorm", 4), _heads()
        cif = dict(encoder_embed_dim=D, max_feat_len=14)
        return (jb.HybridBranchPlus(ta=jb.TransformerArgs(**ta), head=jh,
                                    cif=JCifConfig(cif_output_dim=D, **cif), out_dim=W),
                lambda: pb.HybridBranchPlus(pb.TransformerArgs(**ta), ph, CifConfig(**cif),
                                            out_dim=W))
    raise KeyError(name)


BRANCHES = ["parallel", "parallel_noproj", "cascaded", "cascaded_perkw", "hybrid", "hybrid_mlp",
            "cascaded_plus", "hybrid_plus"]


def _setup(name, seed=3):
    jmod, make = _branch_pair(name)
    x, lens, rng = _inputs(seed, b=4, t=40)
    emb = (rng.randn(V, W) * 0.3).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(lens))
    if not name.startswith("parallel"):
        args += (jnp.asarray(emb),)
    variables = _np(jmod.init(jax.random.PRNGKey(0), *args))
    variables.setdefault("batch_stats", {})
    if "downsampling" in variables["params"]:
        variables["params"]["downsampling"]["weight_proj"]["bias"] = np.full(1, -1.0, np.float32)
    if "head" in variables["params"]:  # BN parameters other than (1, 0)
        bn = variables["params"]["head"]["bn_layer"]
        bn["scale"] = (rng.rand(*bn["scale"].shape) + 0.5).astype(np.float32)
        bn["bias"] = rng.randn(*bn["bias"].shape).astype(np.float32)
    port = _fill(make(), from_jax._fill_branch, variables["params"], variables["batch_stats"])
    return jmod, make, port, variables, x, lens, emb, rng


@pytest.mark.parametrize("name", BRANCHES)
def test_branch_training_forward_and_gradients_match_jax(name):
    jmod, make, port, variables, x, lens, emb, rng = _setup(name)
    plus = name.endswith("plus")
    parallel_only = name.startswith("parallel")
    target_len = np.maximum(np.round(lens / 5.0), 1).astype(np.int64)
    p_probe = rng.randn(4, W if name != "parallel_noproj" else D).astype(np.float32)

    def jrun(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        if parallel_only:
            out = jmod.apply(v, jnp.asarray(x), jnp.asarray(lens))
            return (out["parallel_audio_feat"] * p_probe).sum(), (out, {})
        kw = dict(training=True, deterministic=True)
        if plus:
            kw.update(target_len=jnp.asarray(target_len), global_step=jnp.asarray(3))
        out, new = jmod.apply(v, jnp.asarray(x), jnp.asarray(lens), jnp.asarray(emb),
                              mutable=["batch_stats"], **kw)
        loss = (out["keywords"] * k_probe).sum()
        if "parallel_audio_feat" in out:
            loss = loss + (out["parallel_audio_feat"] * p_probe).sum()
        if plus:
            loss = loss + out["dsample_results"]["quantity_out"].sum()
        return loss, (out, new["batch_stats"])

    if not parallel_only:  # the keywords' shape, for the probe
        shape = jax.eval_shape(lambda: jmod.apply(
            variables, jnp.asarray(x), jnp.asarray(lens), jnp.asarray(emb)))["keywords"].shape
        k_probe = rng.randn(*shape).astype(np.float32)
    (jloss, (jout, jstats)), jgrads = jax.value_and_grad(jrun, has_aux=True)(variables["params"])

    xt, lt = torch.from_numpy(x), torch.from_numpy(lens)
    if parallel_only:
        out = port(xt, lt)
        loss = (out["parallel_audio_feat"] * torch.from_numpy(p_probe)).sum()
    else:
        kw = dict(training=True)
        if plus:
            kw.update(target_len=torch.from_numpy(target_len), global_step=3)
        out = port(xt, lt, torch.from_numpy(emb), **kw)
        loss = (out["keywords"] * torch.from_numpy(k_probe)).sum()
        if "parallel_audio_feat" in out:
            loss = loss + (out["parallel_audio_feat"] * torch.from_numpy(p_probe)).sum()
        if plus:
            loss = loss + out["dsample_results"]["quantity_out"].sum()
    loss.backward()

    for key in ("parallel_audio_feat", "keywords"):
        assert (key in out) == (key in jout), key
        if key in out:
            np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(jout[key]),
                                       atol=ATOL, rtol=0, err_msg=key)
    if not parallel_only:
        np.testing.assert_array_equal(out["vq_results"]["targets"].numpy(),
                                      np.asarray(jout["vq_results"]["targets"]))
        for key in ("code_perplexity", "prob_perplexity"):
            np.testing.assert_allclose(float(out["vq_results"][key]),
                                       float(jout["vq_results"][key]), rtol=1e-4)
        bn = port.head.bn_layer
        jbn = jstats["head"]["bn_layer"]
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(jbn["mean"]), atol=ATOL)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(jbn["var"]), atol=ATOL)
        assert bn.running_mean.shape == np.asarray(jbn["mean"]).shape
    if plus:
        np.testing.assert_array_equal(out["keywords_len"].numpy(),
                                      np.asarray(jout["keywords_len"]))
        assert len(set(out["keywords_len"].tolist())) > 1
    else:
        assert out.get("keyword_num") == jout.get("keyword_num")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _check_grads(port, make, from_jax._fill_branch, _np(jgrads), variables["batch_stats"])


@pytest.mark.parametrize("name", BRANCHES)
def test_branch_eval_and_hidden_states_match_jax(name):
    jmod, _, port, variables, x, lens, emb, _ = _setup(name, seed=4)
    port.eval()
    args = (jnp.asarray(x), jnp.asarray(lens))
    targs = (torch.from_numpy(x), torch.from_numpy(lens))
    with torch.inference_mode():
        if name.startswith("parallel"):
            out, jout = port(*targs), jmod.apply(variables, *args)
        else:
            out = port(*targs, torch.from_numpy(emb))
            jout = jmod.apply(variables, *args, jnp.asarray(emb))
            np.testing.assert_array_equal(out["vq_results"]["targets"].numpy(),
                                          np.asarray(jout["vq_results"]["targets"]))
        for key in ("parallel_audio_feat", "keywords"):
            if key in jout:
                np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]), atol=ATOL,
                                           rtol=0, err_msg=key)
        if hasattr(port, "parallel_feature"):
            np.testing.assert_allclose(port.parallel_feature(*targs).numpy(),
                                       np.asarray(jout["parallel_audio_feat"]), atol=ATOL, rtol=0)
        hs = port.extract_hidden_states(*targs)
    jhs = jmod.apply(variables, *args, method=type(jmod).extract_hidden_states)
    assert len(hs) == len(jhs) == 2
    for a, b in zip(hs, jhs):
        assert a.shape == (4, 40, D)  # the CLS rows are cut off
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["cascaded", "cascaded_perkw"])
def test_attention_map_matches_jax(name):
    jmod, _, port, variables, x, lens, _, _ = _setup(name, seed=5)
    want = jmod.apply(variables, jnp.asarray(x), jnp.asarray(lens),
                      method=jb.CascadedBranch.get_attention_map) \
        if name == "cascaded" else None
    with torch.inference_mode():
        if name == "cascaded_perkw":  # a TransformerEncoder has no attention map, as in JAX
            with pytest.raises(AttributeError):
                port.get_attention_map(torch.from_numpy(x), torch.from_numpy(lens))
            return
        got = port.get_attention_map(torch.from_numpy(x), torch.from_numpy(lens))
    assert got.shape == (4, 1, 4, 44)  # (B, heads, K, K + T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    assert float(got[1, :, :, 4 + int(lens[1]):].abs().max()) == 0.0  # no weight on padding


def test_transformer_args_keep_the_yaml_keys():
    node = dict(type="TransformerEncoder", n_layers=2, d_model=64, nhead=1, dim_feedforward=128,
                dropout=0.2, activation="relu", layer_norm_eps=1e-6, batch_first=True,
                norm_first=True)
    ta = pb.TransformerArgs.from_config(node)
    want = jb.TransformerArgs.from_config(node)
    for f in dataclasses.fields(pb.TransformerArgs):
        if f.name != "compute_dtype":
            assert getattr(ta, f.name) == getattr(want, f.name), f.name
    enc = pb.make_self_att(ta)
    assert len(enc.layers) == 2 and enc.layers[0].norm_first and enc.layers[0].act is torch.relu
    with pytest.raises(NotImplementedError, match="branch transformer"):
        pb.make_self_att(dataclasses.replace(ta, type="Conformer"))
