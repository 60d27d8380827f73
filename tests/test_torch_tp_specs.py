"""The port's tensor-parallel sharding rules against JAX's, on the CPU.

Every leaf of JAX's tiny hybrid+ and continuous models is tagged with the
shard index that `speechclip_plus_tpu.parallel.tp.param_partition_spec`
gives each of its elements (-1 where JAX replicates the leaf), and the tagged
tree is moved into the port through `checkpoint/from_jax.py`. The port's
`partition_plan` must then shard every counterpart along the matching
dimension (JAX's q/k/v columns are the packed in-projection's head rows: each
rank's shard holds only its own tags) and replicate what JAX replicates. The
one logged deviation (ROADMAP C: HuBERT's attention sharded by whole heads)
does not arise at this size (4 heads, tp 2 and 4). Also: indivisible
dimensions are replicated, Adam's moments are shard-local, and every model
YAML, with a mel upstream or a trainable tower too, shards at full width
(built on the meta device) under tp 2 and 4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import tree_flatten_with_path, tree_unflatten

from speechclip_plus_tpu.config import load_config as jax_load_config
from speechclip_plus_tpu.models.kwclip import KWClip as JKWClip
from speechclip_plus_tpu.models.kwclip import KWClipConfig as JKWClipConfig
from speechclip_plus_tpu.parallel.tp import param_partition_spec as jax_spec
from speechclip_plus_tpu.tasks.builder import resolve_reduced_vocab as jax_vocab

import torch_dp_ranks as ranks_mod
from speechclip_plus_tpu_torch.checkpoint.from_jax import load_jax_variables
from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.optim.optimizer import build_optimizer_from_config
from speechclip_plus_tpu_torch.parallel import tp
from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config

MODEL_AXIS = "model"


def _jax_variables(continuous: bool):
    cfg = jax_load_config(ranks_mod.TINY)
    if continuous:
        cfg.model_settings.cascaded_objective_weight = 0.0
    vocab = jax_vocab(cfg)
    mcfg = JKWClipConfig.from_config(cfg, vocab_size=len(vocab), sot_id=int(vocab.sot_reduced),
                                     eot_id=int(vocab.eot_reduced))
    model = JKWClip(mcfg)
    batch = {k: jnp.asarray(v) for k, v in ranks_mod.global_batch(2, 0).items()}
    variables = jax.jit(lambda k, b: model.init({"params": k}, b, training=False))(
        jax.random.PRNGKey(0), batch)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    if continuous:  # the port's frozen CLIP has the text tower the continuous path never runs
        text = jax.jit(lambda k, t: model.init({"params": k}, t, method=JKWClip.forward_text))(
            jax.random.PRNGKey(1), jnp.zeros((1, mcfg.clip.context_length), jnp.int32))
        variables["params"]["clip"]["text"] = jax.tree_util.tree_map(
            np.array, dict(text["params"]["clip"]["text"]))
    return variables


@pytest.fixture(scope="module", params=["hybrid_plus", "continuous"])
def pair(request):
    continuous = request.param == "continuous"
    cfg = load_config(ranks_mod.TINY)
    if continuous:
        cfg.model_settings.cascaded_objective_weight = 0.0
    port, _, _ = build_model_from_config(cfg, device="cpu", seed=0)
    return port, _jax_variables(continuous)


def _tagged(params, tp_size):
    """Each leaf's elements tagged with their shard index along JAX's model
    axis, -1 on a replicated leaf."""
    flat, treedef = tree_flatten_with_path(params)
    leaves = []
    for path, leaf in flat:
        spec = jax_spec(path, leaf.shape, tp_size)
        axes = [i for i, a in enumerate(tuple(spec)) if a == MODEL_AXIS]
        tag = np.full(leaf.shape, -1.0, np.float32)
        if axes:
            (ax,) = axes
            idx = np.arange(leaf.shape[ax]) // (leaf.shape[ax] // tp_size)
            shape = [1] * leaf.ndim
            shape[ax] = leaf.shape[ax]
            tag = np.broadcast_to(idx.reshape(shape), leaf.shape).astype(np.float32)
        leaves.append(tag)
    return tree_unflatten(treedef, leaves)


@pytest.mark.parametrize("tp_size", [2, 4])
def test_port_shards_what_jax_shards(pair, tp_size):
    port, variables = pair
    stats = jax.tree_util.tree_map(lambda a: np.zeros_like(a, np.float32),
                                   variables.get("batch_stats", {}))
    load_jax_variables(port, {"params": _tagged(variables["params"], tp_size),
                              "batch_stats": stats})
    plan = tp.partition_plan(port, tp_size)
    sharded = 0
    for name, p in port.named_parameters():
        t = p.detach().float()
        if plan[name] is None:
            assert bool((t == -1).all()), f"{name}: JAX shards it, the port replicates it"
            continue
        sharded += 1
        for r in range(tp_size):
            part = tp.shard_tensor(name, t, plan[name], r, tp_size)
            assert bool((part == r).all()), f"{name}: shard {r} holds another rank's slice"
    assert sharded >= 6


def test_indivisible_dimensions_are_replicated():
    spec = tp.param_partition_spec
    assert spec("audio_encoder.layers.0.fc1.weight", (3072, 768), 2) == 0
    assert spec("audio_encoder.layers.0.fc1.weight", (769, 768), 2) is None
    assert spec("audio_encoder.layers.0.fc2.weight", (768, 769), 2) is None
    assert spec("audio_encoder.layers.0.fc2.bias", (768,), 2) is None  # row bias replicated
    assert spec("clip.text.token_embedding.weight", (8112, 512), 2) == 0
    assert spec("clip.text.token_embedding.weight", (8113, 512), 2) is None
    assert spec("clip.text.transformer.blocks.0.c_proj.weight", (512, 2048), 4) == 1
    # HuBERT's attention by whole heads: 12 heads split 2 and 4 ways, not 8
    name = "audio_encoder.layers.0.self_attn.in_proj_weight"
    assert spec(name, (2304, 768), 4, heads=12) == 0
    assert spec(name, (2304, 768), 8, heads=12) is None  # the logged deviation
    assert spec("audio_encoder.layers.0.self_attn.out_proj.weight", (768, 768), 2,
                heads=12) == 1
    # packed attentions outside HuBERT stay replicated, as JAX's _PACKED_ATTN
    assert spec("parallel_branch.self_att.layers.0.self_attn.in_proj_weight", (96, 32), 2) is None
    assert spec("clip.text.transformer.blocks.0.attn.in_proj_weight", (1536, 512), 2) is None
    assert spec("audio_encoder.layers.0.self_attn_layer_norm.weight", (768,), 2) is None
    assert spec("audio_encoder.layers.0.fc1.weight", (3072, 768), 1) is None


def test_adam_state_is_shard_local():
    """A trainable tower's sharded tensors keep Adam moments of their shards'
    shape (JAX `train_state_shardings` mirrors each parameter's sharding)."""
    cfg = load_config(ranks_mod.TINY)
    cfg.audio_encoder.trainable = True
    model, _, _ = build_model_from_config(cfg, device="cpu", seed=0)
    full = {n: tuple(p.shape) for n, p in model.named_parameters()}
    mg = tp.ModelGroup(data_rank=0, data_world=1, model_rank=1, model_world=2,
                       device=torch.device("cpu"))
    plan = tp.shard_model(model, mg)
    opt = build_optimizer_from_config(model, cfg)
    for p in opt.params:
        p.grad = torch.ones_like(p)
    opt.adam.step()
    names = {id(p): n for n, p in model.named_parameters()}
    seen = 0
    for p in opt.params:
        n = names[id(p)]
        st = opt.adam.state[p]
        assert st["exp_avg"].shape == st["exp_avg_sq"].shape == p.shape, n
        if plan[n] is not None:
            seen += 1
            want = list(full[n])
            want[plan[n]] //= 2
            assert tuple(p.shape) == tuple(want), n
    assert seen >= 6
    assert opt.model_group is mg and sum(opt.sharded) == seen
    with pytest.raises(ValueError, match="sharded already"):
        tp.shard_model(model, mg)


def _model_yamls():
    import glob
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = sorted(glob.glob(os.path.join(root, "config", "speechclip*", "**", "*.yaml"),
                             recursive=True))
    return [p for p in paths if "synthetic" not in p]


@pytest.mark.parametrize("tp_size", [2, 4])
@pytest.mark.parametrize("variant", ["yaml", "apc", "tera", "trainable"])
def test_every_model_shards_at_full_width(tp_size, variant):
    """Every model YAML (and the base hybrid+ with a mel upstream or a
    trainable top of the tower) builds at full width (on the meta device, no
    weights) and shards: each sharded tensor's dimension divides, the shard
    is 1/tp of it, and the modules know which of their products are sharded
    (HuBERT's attention by head wherever tp divides its 12 or 16 heads)."""
    from speechclip_plus_tpu_torch.models.hubert import HubertEncoderLayer
    from speechclip_plus_tpu_torch.models.kwclip import KWClip, KWClipConfig
    from speechclip_plus_tpu_torch.tasks.builder import resolve_reduced_vocab

    paths = _model_yamls() if variant == "yaml" else [
        p for p in _model_yamls() if p.endswith("base/hybrid_plus.yaml")]
    assert len(paths) >= (19 if variant == "yaml" else 1)
    mg = tp.ModelGroup(data_rank=0, data_world=1, model_rank=tp_size - 1, model_world=tp_size,
                       device=torch.device("meta"))
    for path in paths:
        cfg = load_config(path)
        if variant in ("apc", "tera"):
            cfg.audio_encoder.name = variant
        if variant == "trainable":
            cfg.audio_encoder.trainable = True
            cfg.audio_encoder.unfreeze_layers = [10, 11]
        vocab = resolve_reduced_vocab(cfg)
        mc = KWClipConfig.from_config(cfg, vocab_size=len(vocab), sot_id=int(vocab.sot_reduced),
                                      eot_id=int(vocab.eot_reduced))
        with torch.device("meta"):
            model = KWClip(mc)
        full = {n: tuple(p.shape) for n, p in model.named_parameters()}
        plan = tp.shard_model(model, mg)
        for n, p in model.named_parameters():
            want = list(full[n])
            if plan[n] is not None:
                assert want[plan[n]] % tp_size == 0, (path, n)
                want[plan[n]] //= tp_size
            assert tuple(p.shape) == tuple(want), (path, n)
        assert sum(s is not None for s in plan.values()) >= 8, path
        for mod in model.modules():
            if isinstance(mod, HubertEncoderLayer):
                assert mod.tp_heads == (mod.cfg.n_heads % tp_size == 0), path
                assert (mod.self_attn.tp is not None) == mod.tp_heads
        vocab_sharded = plan["clip.text.token_embedding.weight"] is not None
        assert vocab_sharded == (len(vocab) % tp_size == 0), path
        assert (model.clip.text.tp is not None) == vocab_sharded
