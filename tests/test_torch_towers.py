"""The port's tower importers against the JAX package's (CPU, no weights needed).

Seeded state dicts under the exact key names of each format (fairseq HuBERT
with a weight-normed pos_conv, HF HuBERT with the parametrizations layout, HF
WavLM, HF data2vec-audio, OpenAI CLIP, HF CLIP), at tiny size, built here: no
`transformers` import. Each goes through the port's importer into a port
tower and through JAX's importer followed by `from_jax.load_hubert` /
`load_clip`; the two towers must be equal tensor for tensor. Also
`materialize_weight_norm`, `reduce_token_embedding`,
`hubert_config_from_fairseq_sd` and `clip_config_from_openai_sd` against JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

from speechclip_plus_tpu.checkpoint import towers as jtowers
from speechclip_plus_tpu.models.clip import ClipConfig as JClipConfig
from speechclip_plus_tpu.models.hubert import HubertConfig as JHubertConfig
from speechclip_plus_tpu_torch.checkpoint import towers
from speechclip_plus_tpu_torch.checkpoint.from_jax import load_clip, load_hubert
from speechclip_plus_tpu_torch.checkpoint.torch_import import load_port_state_dict
from speechclip_plus_tpu_torch.models.clip import ClipConfig, ClipModel
from speechclip_plus_tpu_torch.models.hubert import HubertConfig, HubertModel

D2V = dict(extractor_mode="layer_norm", conv_pos=19, pos_conv_depth=5)


class _Rand:
    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)

    def __call__(self, *shape):
        return self.rng.randn(*shape).astype(np.float32)

    def lin(self, sd, name, dout, din):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = self(dout, din), self(dout)

    def norm(self, sd, name, d):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = self(d), self(d)


def hubert_sd(fmt, cfg, seed=0):
    """A tower state dict in `fmt` ("fairseq", "hf", "wavlm", "data2vec")."""
    r, sd, d, c0 = _Rand(seed), {}, cfg.d_model, cfg.conv_layers[0][0]
    conv = "{}.0" if fmt == "fairseq" else "{}.conv"
    cin = 1
    for i, (ch, k, _) in enumerate(cfg.conv_layers):
        sd[f"feature_extractor.conv_layers.{conv.format(i)}.weight"] = r(ch, cin, k)
        cin = ch
        if fmt == "data2vec":
            r.norm(sd, f"feature_extractor.conv_layers.{i}.layer_norm", ch)
    if fmt == "fairseq":
        r.norm(sd, "feature_extractor.conv_layers.0.2", c0)
        r.norm(sd, "layer_norm", c0)
        r.lin(sd, "post_extract_proj", d, c0)
        g, v = np.abs(r(1, 1, cfg.conv_pos)), r(d, d // cfg.conv_pos_groups, cfg.conv_pos)
        sd["encoder.pos_conv.0.weight_g"], sd["encoder.pos_conv.0.weight_v"] = g, v
        sd["encoder.pos_conv.0.bias"] = r(d)
    else:
        if fmt != "data2vec":
            r.norm(sd, "feature_extractor.conv_layers.0.layer_norm", c0)
        r.norm(sd, "feature_projection.layer_norm", c0)
        r.lin(sd, "feature_projection.projection", d, c0)
        if fmt == "data2vec":
            for j in range(cfg.pos_conv_depth):
                r.lin(sd, f"encoder.pos_conv_embed.layers.{j}.conv", d, d)
                sd[f"encoder.pos_conv_embed.layers.{j}.conv.weight"] = r(
                    d, d // cfg.conv_pos_groups, cfg.conv_pos)
        else:
            p = "encoder.pos_conv_embed.conv."
            sd[f"{p}parametrizations.weight.original0"] = np.abs(r(1, 1, cfg.conv_pos))
            sd[f"{p}parametrizations.weight.original1"] = r(d, d // cfg.conv_pos_groups,
                                                           cfg.conv_pos)
            sd[f"{p}bias"] = r(d)
    r.norm(sd, "encoder.layer_norm", d)
    att, ln, fc1, fc2 = (("self_attn", "self_attn_layer_norm", "fc1", "fc2") if fmt == "fairseq"
                         else ("attention", "layer_norm", "feed_forward.intermediate_dense",
                               "feed_forward.output_dense"))
    for i in range(cfg.n_layers):
        lp = f"encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            r.lin(sd, f"{lp}{att}.{proj}", d, d)
        r.norm(sd, f"{lp}{ln}", d)
        r.lin(sd, f"{lp}{fc1}", cfg.ffn_dim, d)
        r.lin(sd, f"{lp}{fc2}", d, cfg.ffn_dim)
        r.norm(sd, f"{lp}final_layer_norm", d)
        if fmt == "wavlm":
            r.lin(sd, f"{lp}attention.gru_rel_pos_linear", 8, d // cfg.n_heads)
            sd[f"{lp}attention.gru_rel_pos_const"] = r(1, cfg.n_heads, 1, 1)
    if fmt == "wavlm":
        sd["encoder.layers.0.attention.rel_attn_embed.weight"] = r(cfg.rel_buckets, cfg.n_heads)
    return sd


HUBERT_FORMATS = {  # format -> (port importer, JAX importer, tower config keys)
    "fairseq": (towers.fairseq_hubert_to_port, jtowers.fairseq_hubert_to_flax, {}),
    "hf": (towers.hf_hubert_to_port, jtowers.hf_hubert_to_flax, {}),
    "wavlm": (towers.hf_wavlm_to_port, jtowers.hf_wavlm_to_flax, {"rel_pos_bias": True}),
    "data2vec": (towers.hf_data2vec_audio_to_port, jtowers.hf_data2vec_audio_to_flax, D2V),
}


def _assert_equal_modules(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name


@pytest.mark.parametrize("fmt", list(HUBERT_FORMATS))
def test_hubert_importers_match_jax(fmt):
    port_import, jax_import, keys = HUBERT_FORMATS[fmt]
    cfg, jcfg = HubertConfig.tiny(**keys), JHubertConfig.tiny(**keys)
    sd = hubert_sd(fmt, cfg)
    port = HubertModel(cfg)
    load_port_state_dict(port, port_import(sd, cfg))
    bridged = HubertModel(cfg)
    load_hubert(bridged, jax_import(sd, jcfg))
    _assert_equal_modules(port, bridged)
    # with a prefix, as inside a Lightning checkpoint
    prefixed = {f"audio_encoder.encoder.{k}": v for k, v in sd.items()}
    again = HubertModel(cfg)
    load_port_state_dict(again, port_import(prefixed, cfg, prefix="audio_encoder.encoder."))
    _assert_equal_modules(port, again)


def test_hubert_importer_names_a_missing_key():
    cfg = HubertConfig.tiny()
    sd = hubert_sd("hf", cfg)
    sd.pop("encoder.layers.1.attention.k_proj.bias")
    with pytest.raises(KeyError, match="encoder.layers.1.attention.k_proj.bias"):
        towers.hf_hubert_to_port(sd, cfg)


def clip_sd(fmt, c, seed=1):
    """A CLIP state dict in `fmt` ("openai" or "hf")."""
    r, sd = _Rand(seed), {}
    n_pos = (c.image_resolution // c.vision_patch_size) ** 2 + 1
    if fmt == "openai":
        sd["visual.conv1.weight"] = r(c.vision_width, 3, c.vision_patch_size, c.vision_patch_size)
        sd["visual.class_embedding"] = r(c.vision_width)
        sd["visual.positional_embedding"] = r(n_pos, c.vision_width)
        r.norm(sd, "visual.ln_pre", c.vision_width)
        r.norm(sd, "visual.ln_post", c.vision_width)
        sd["visual.proj"] = r(c.vision_width, c.embed_dim)
        for pref, w, n in (("visual.transformer.", c.vision_width, c.vision_layers),
                           ("transformer.", c.text_width, c.text_layers)):
            for i in range(n):
                bp = f"{pref}resblocks.{i}."
                sd[f"{bp}attn.in_proj_weight"] = r(3 * w, w)
                sd[f"{bp}attn.in_proj_bias"] = r(3 * w)
                r.lin(sd, f"{bp}attn.out_proj", w, w)
                r.norm(sd, f"{bp}ln_1", w)
                r.norm(sd, f"{bp}ln_2", w)
                r.lin(sd, f"{bp}mlp.c_fc", 4 * w, w)
                r.lin(sd, f"{bp}mlp.c_proj", w, 4 * w)
        sd["token_embedding.weight"] = r(c.vocab_size, c.text_width)
        sd["positional_embedding"] = r(c.context_length, c.text_width)
        r.norm(sd, "ln_final", c.text_width)
        sd["text_projection"] = r(c.text_width, c.embed_dim)
    else:
        v, t = "vision_model.", "text_model."
        sd[f"{v}embeddings.patch_embedding.weight"] = r(c.vision_width, 3, c.vision_patch_size,
                                                        c.vision_patch_size)
        sd[f"{v}embeddings.class_embedding"] = r(c.vision_width)
        sd[f"{v}embeddings.position_embedding.weight"] = r(n_pos, c.vision_width)
        r.norm(sd, f"{v}pre_layrnorm", c.vision_width)
        r.norm(sd, f"{v}post_layernorm", c.vision_width)
        sd["visual_projection.weight"] = r(c.embed_dim, c.vision_width)
        for pref, w, n in ((f"{v}encoder.", c.vision_width, c.vision_layers),
                           (f"{t}encoder.", c.text_width, c.text_layers)):
            for i in range(n):
                bp = f"{pref}layers.{i}."
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    r.lin(sd, f"{bp}self_attn.{proj}", w, w)
                r.norm(sd, f"{bp}layer_norm1", w)
                r.norm(sd, f"{bp}layer_norm2", w)
                r.lin(sd, f"{bp}mlp.fc1", 4 * w, w)
                r.lin(sd, f"{bp}mlp.fc2", w, 4 * w)
        sd[f"{t}embeddings.token_embedding.weight"] = r(c.vocab_size, c.text_width)
        sd[f"{t}embeddings.position_embedding.weight"] = r(c.context_length, c.text_width)
        r.norm(sd, f"{t}final_layer_norm", c.text_width)
        sd["text_projection.weight"] = r(c.embed_dim, c.text_width)
    sd["logit_scale"] = np.asarray(2.6593, np.float32)
    return sd


@pytest.mark.parametrize("fmt", ["openai", "hf"])
def test_clip_importers_match_jax(fmt):
    cfg, jcfg = ClipConfig.tiny(), JClipConfig.tiny()
    sd = clip_sd(fmt, cfg)
    port = ClipModel(cfg)
    if fmt == "openai":
        load_port_state_dict(port, towers.openai_clip_to_port(sd, cfg))
        jparams = jtowers.openai_clip_to_flax(sd, jcfg)
    else:
        load_port_state_dict(port, towers.hf_clip_to_port(sd, cfg))
        jparams = jtowers.hf_clip_to_flax(sd, jcfg)
    bridged = ClipModel(cfg)
    load_clip(bridged, jparams)
    _assert_equal_modules(port, bridged)


def test_materialize_weight_norm_matches_jax():
    r = _Rand(3)
    g, v = np.abs(r(1, 1, 19)), r(16, 8, 19)
    got = towers.materialize_weight_norm(g, v)
    np.testing.assert_array_equal(got, jtowers.materialize_weight_norm(g, v))
    # torch's weight_norm(dim=2): ||w[:, :, k]|| = g[k]
    np.testing.assert_allclose(np.sqrt((got.astype(np.float64) ** 2).sum(axis=(0, 1))),
                               g.reshape(-1), rtol=1e-6)


def test_reduce_token_embedding_matches_jax():
    cfg, jcfg = ClipConfig.tiny(), JClipConfig.tiny()
    sd = clip_sd("openai", cfg)
    state = towers.openai_clip_to_port(sd, cfg)
    ids = [5, 0, 63, 17, 62]
    got = towers.reduce_token_embedding(state, ids)
    want = jtowers.reduce_token_embedding(jtowers.openai_clip_to_flax(sd, jcfg), ids)
    np.testing.assert_array_equal(got["text.token_embedding.weight"],
                                  want["text"]["token_embedding"]["embedding"])
    assert state["text.token_embedding.weight"].shape[0] == cfg.vocab_size  # a new dict
    small = ClipModel(dataclasses.replace(cfg, vocab_size=len(ids), sot_id=4, eot_id=2))
    load_port_state_dict(small, got)


def test_config_inference_matches_jax():
    base = HubertConfig()
    sd = {"encoder.layers.0.fc1.weight": np.zeros((base.ffn_dim, base.d_model), np.float32)}
    got, want = towers.hubert_config_from_fairseq_sd(sd), jtowers.hubert_config_from_fairseq_sd(sd)
    for name in ("conv_layers", "extractor_mode", "conv_bias", "d_model", "n_layers",
                 "n_heads", "ffn_dim", "layer_norm_first", "conv_pos", "conv_pos_groups",
                 "pos_conv_depth", "rel_pos_bias"):  # the architecture
        assert getattr(got, name) == getattr(want, name), name
    assert not got.conv_bias and not want.conv_bias  # the base frontend convs have no bias
    large = {"p.encoder.layers.0.fc1.weight": np.zeros((4096, 1024), np.float32)}
    got, want = (towers.hubert_config_from_fairseq_sd(large, "p."),
                 jtowers.hubert_config_from_fairseq_sd(large, "p."))
    assert want.d_model == 1024 and got == HubertConfig.large()  # the large family is ported
    for name in ("conv_layers", "extractor_mode", "conv_bias", "d_model", "n_layers", "n_heads",
                 "ffn_dim", "layer_norm_first", "conv_pos", "pos_conv_depth"):
        assert getattr(got, name) == getattr(want, name), name

    cfg = ClipConfig.tiny()
    for prefix in ("", "clip.model."):
        sd = {f"{prefix}{k}": v for k, v in clip_sd("openai", cfg).items()}
        got = towers.clip_config_from_openai_sd(sd, prefix)
        want = jtowers.clip_config_from_openai_sd(sd, prefix)
        for f in dataclasses.fields(ClipConfig):
            if f.name not in ("dtype", "text_remat_mode", "text_fused_attention_vjp"):
                assert getattr(got, f.name) == getattr(want, f.name), (prefix, f.name)
        assert (got.vision_layers, got.text_layers, got.vision_width) == (
            cfg.vision_layers, cfg.text_layers, cfg.vision_width)
