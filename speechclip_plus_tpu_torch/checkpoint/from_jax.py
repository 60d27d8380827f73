"""Weight bridge: JAX `speechclip_plus_tpu` variables -> a port model.

Fills a `KWClip` (or one of its towers) from the JAX package's `variables`
(`params` and `batch_stats`, nested dicts of numpy arrays), so both packages
compute the same function in the parity tests. The layout rules:

  - Dense kernels are (in, out); `nn.Linear` weights are (out, in).
  - Flax `nn.Conv` kernels are (k, in/groups, out) [2-D: (kh, kw, in, out)];
    torch's are (out, in/groups, k) [(out, in, kh, kw)].
  - Scanned layers (the JAX default `scan_layers=True`) are stacked along a
    leading L axis (`layers/layer`, `transformer/blocks/block`) and are
    unstacked here.
  - HuBERT's separate q/k/v projections become the packed `in_proj`.
  - WavLM adds the shared `rel_attn_embed` table and, per scanned layer,
    `gru_rel_pos_linear` and `gru_rel_pos_const`; data2vec has a LayerNorm
    `ln_i` after every frontend conv and the stacked `pos_conv/conv_j`;
    HuBERT- and WavLM-Large add a `bias` to every `conv_i` and the `ln_i`;
    their pre-norm layers have the post-norm layers' leaves.
  - LayerNorm / GroupNorm `scale` is torch's `weight`.
  - The pos-conv kernel is the weight-norm-materialized one the JAX side
    stores (``models/hubert.py:627-680``); it is copied as is.
  - Keyword-BN `batch_stats` become the running-statistic buffers, in the
    variant's layout ((D,), (D*K,) or (K, D)).
  - A mel upstream's `audio_encoder` subtree is `lstm/layer_i/{w_ih, w_hh,
    b_ih, b_hh}` (torch's layout already: copied as is onto each layer's
    `weight_ih_l0` ...), or `input_proj`, `input_norm` and `layer_i/{self_attn,
    norm1, norm2, linear1, linear2}`.
  - CIF's alpha net is `conv_i` (the port's `conv`, then `conv_1`, ...) or
    `dense_proj`, then `weight_proj`, with `cif_output_proj` where the
    output width differs; a learnable VQ temperature is
    `head/vector_quantizer/curr_temp`.
  - The branch transformer is `multihead_attn_layer` + `attentionBlock_Norm`,
    or `layer_i/{self_attn, norm1, norm2, linear1, linear2}` + `norm`; an MLP
    projection is `dense_i` where a single projection is a Dense.

Strict both ways: every parameter and buffer of the target must be filled
exactly once, and every leaf of the JAX variables must be read; anything
left over on either side raises, as does any shape mismatch. Plain numpy:
the bridge imports neither JAX nor the JAX package.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = ["load_jax_variables", "load_hubert", "load_mel_upstream", "load_clip"]


class _Tree:
    """Read-tracking view of a nested dict of arrays: records the path of
    every leaf read through it, so `unread()` lists what nothing consumed."""

    def __init__(self, tree, path: str = "", seen=None, index=None):
        self._tree, self._path, self._index = tree, path, index
        self._seen = set() if seen is None else seen

    def _wrap(self, key, value):
        path = f"{self._path}/{key}"
        if hasattr(value, "items"):
            return _Tree(value, path, self._seen, self._index)
        self._seen.add(path)
        return value if self._index is None else np.asarray(value)[self._index]

    def layer(self, i: int) -> "_Tree":
        """Layer i of a scanned (stacked along a leading L axis) subtree."""
        return _Tree(self._tree, self._path, self._seen, i)

    def __getitem__(self, key):
        return self._wrap(key, self._tree[key])

    def get(self, key, default=None):
        return self[key] if key in self._tree else default

    def items(self):
        return [(k, self._wrap(k, v)) for k, v in self._tree.items()]

    def unread(self):
        def leaves(tree, path):
            for k, v in tree.items():
                if hasattr(v, "items"):
                    yield from leaves(v, f"{path}/{k}")
                else:
                    yield f"{path}/{k}"
        return sorted(p for p in leaves(self._tree, self._path) if p not in self._seen)


class _Filler:
    def __init__(self, module: nn.Module):
        # parameters and persistent buffers (not the derived causal mask)
        self.todo = {id(t): name for name, t in module.state_dict(keep_vars=True).items()}

    def put(self, tensor: torch.Tensor, array) -> None:
        array = np.asarray(array, dtype=np.float32)
        if tuple(tensor.shape) != array.shape:
            raise ValueError(f"{self.todo.get(id(tensor), '?')}: torch {tuple(tensor.shape)} "
                             f"vs jax {array.shape}")
        if self.todo.pop(id(tensor), None) is None:
            raise ValueError("tensor filled twice or not part of the target module")
        with torch.no_grad():
            tensor.copy_(torch.tensor(array))

    def linear(self, mod: nn.Linear, t: Dict) -> None:
        self.put(mod.weight, np.asarray(t["kernel"]).T)
        if mod.bias is not None:
            self.put(mod.bias, t["bias"])

    def norm(self, mod, t: Dict) -> None:
        self.put(mod.weight, t["scale"])
        self.put(mod.bias, t["bias"])

    def conv1d(self, mod: nn.Conv1d, t: Dict) -> None:
        self.put(mod.weight, np.asarray(t["kernel"]).transpose(2, 1, 0))
        if mod.bias is not None:
            self.put(mod.bias, t["bias"])

    def packed_mha(self, mod, t: Dict) -> None:
        """`in_proj/{kernel,bias}` + `out_proj` (CLIP and branch attention)."""
        self.put(mod.in_proj_weight, np.asarray(t["in_proj"]["kernel"]).T)
        self.put(mod.in_proj_bias, t["in_proj"]["bias"])
        self.linear(mod.out_proj, t["out_proj"])

    def finish(self) -> None:
        if self.todo:
            raise ValueError(f"not filled from the JAX variables: {sorted(self.todo.values())}")


def _fill_hubert(f: _Filler, mod, p: Dict) -> None:
    fe, extractor = p["feature_extractor"], mod.feature_extractor
    for i, conv in enumerate(extractor.conv_layers):
        f.conv1d(conv, fe[f"conv_{i}"])
        if extractor.mode == "layer_norm":
            f.norm(extractor.layer_norms[i], fe[f"ln_{i}"])
    if extractor.mode == "group_norm":
        f.norm(extractor.gn, fe["gn_0"])
    f.norm(mod.layer_norm, p["layer_norm"])
    if mod.post_extract_proj is not None:
        f.linear(mod.post_extract_proj, p["post_extract_proj"])
    if hasattr(mod.pos_conv, "layers"):  # data2vec: pos_conv/conv_{j}
        for j, conv in enumerate(mod.pos_conv.layers):
            f.conv1d(conv, p["pos_conv"][f"conv_{j}"])
    else:
        f.conv1d(mod.pos_conv.conv, p["pos_conv"]["conv"])
    f.norm(mod.encoder_layer_norm, p["encoder_layer_norm"])
    if mod.cfg.rel_pos_bias:  # WavLM: the one shared relative-position table
        f.put(mod.rel_attn_embed, p["rel_attn_embed"])
    for i, layer in enumerate(mod.layers):
        t = p["layers"]["layer"].layer(i)
        w = np.concatenate([np.asarray(t[n]["kernel"]) for n in ("q_proj", "k_proj", "v_proj")], 1)
        b = np.concatenate([np.asarray(t[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")])
        f.put(layer.self_attn.in_proj_weight, w.T)
        f.put(layer.self_attn.in_proj_bias, b)
        f.linear(layer.self_attn.out_proj, t["out_proj"])
        f.norm(layer.self_attn_layer_norm, t["self_attn_layer_norm"])
        f.linear(layer.fc1, t["fc1"])
        f.linear(layer.fc2, t["fc2"])
        f.norm(layer.final_layer_norm, t["final_layer_norm"])
        if mod.cfg.rel_pos_bias:
            f.linear(layer.gru_rel_pos_linear, t["gru_rel_pos_linear"])
            f.put(layer.gru_rel_pos_const, t["gru_rel_pos_const"])


def _fill_encoder_layer(f: _Filler, layer, t: Dict) -> None:
    """torch's `TransformerEncoderLayer`: `self_attn`, `norm1/2`, `linear1/2`."""
    f.packed_mha(layer.self_attn, t["self_attn"])
    f.norm(layer.norm1, t["norm1"])
    f.norm(layer.norm2, t["norm2"])
    f.linear(layer.linear1, t["linear1"])
    f.linear(layer.linear2, t["linear2"])


def _fill_mel(f: _Filler, mod, p: Dict) -> None:
    if mod.cfg.arch == "lstm":
        for i in range(mod.cfg.n_layers):
            layer, t = getattr(mod.lstm, f"layer_{i}"), p["lstm"][f"layer_{i}"]
            for name in ("ih", "hh"):
                f.put(getattr(layer, f"weight_{name}_l0"), t[f"w_{name}"])
                f.put(getattr(layer, f"bias_{name}_l0"), t[f"b_{name}"])
        return
    f.linear(mod.input_proj, p["input_proj"])
    f.norm(mod.input_norm, p["input_norm"])
    for i, layer in enumerate(mod.layers):
        _fill_encoder_layer(f, layer, p[f"layer_{i}"])


def _fill_audio(f: _Filler, mod, p: Dict) -> None:
    """Either acoustic tower: a mel upstream has `cfg.arch`."""
    (_fill_mel if hasattr(mod.cfg, "arch") else _fill_hubert)(f, mod, p)


def _fill_blocks(f: _Filler, transformer, p: Dict) -> None:
    for i, block in enumerate(transformer.blocks):
        t = p["blocks"]["block"].layer(i)
        f.norm(block.ln_1, t["ln_1"])
        f.packed_mha(block.attn, t["attn"])
        f.norm(block.ln_2, t["ln_2"])
        f.linear(block.c_fc, t["c_fc"])
        f.linear(block.c_proj, t["c_proj"])


def _fill_clip(f: _Filler, mod, p: Dict) -> None:
    v, pv = mod.visual, p["visual"]
    f.put(v.conv1.weight, np.asarray(pv["conv1"]["kernel"]).transpose(3, 2, 0, 1))
    f.put(v.class_embedding, pv["class_embedding"])
    f.put(v.positional_embedding, pv["positional_embedding"])
    f.norm(v.ln_pre, pv["ln_pre"])
    _fill_blocks(f, v.transformer, pv["transformer"])
    f.norm(v.ln_post, pv["ln_post"])
    f.put(v.proj, pv["proj"])
    t, pt = mod.text, p["text"]
    f.put(t.token_embedding.weight, pt["token_embedding"]["embedding"])
    f.put(t.positional_embedding, pt["positional_embedding"])
    _fill_blocks(f, t.transformer, pt["transformer"])
    f.norm(t.ln_final, pt["ln_final"])
    f.put(t.text_projection, pt["text_projection"])
    f.put(mod.logit_scale, p["logit_scale"])


def _fill_mlp(f: _Filler, mod, t: Dict) -> None:
    """`MLPLayers` (`dense_i`) or a single Linear."""
    if isinstance(mod, nn.Linear):
        return f.linear(mod, t)
    for i, layer in enumerate(mod.layers):
        f.linear(layer, t[f"dense_{i}"])


def _fill_self_att(f: _Filler, mod, t: Dict) -> None:
    """`MultiheadAttentionAndNorm`, or `TransformerEncoder` (`layer_i` + `norm`)."""
    if hasattr(mod, "multihead_attn_layer"):
        f.packed_mha(mod.multihead_attn_layer, t["multihead_attn_layer"])
        return f.norm(mod.attentionBlock_Norm, t["attentionBlock_Norm"])
    for i, layer in enumerate(mod.layers):
        _fill_encoder_layer(f, layer, t[f"layer_{i}"])
    f.norm(mod.norm, t["norm"])


def _fill_branch(f: _Filler, mod, p: Dict, stats: Dict) -> None:
    """Any of the five branches: whichever of the CLS tokens, the parallel
    projection, CIF and the keyword head (with its BN in its layout and the
    running statistics from `batch_stats`) the module has."""
    for name in ("cls", "parallel_cls", "cascaded_cls"):
        if hasattr(mod, name):
            f.put(getattr(mod, name), p[name])
    _fill_self_att(f, mod.self_att, p["self_att"])
    for name in ("parallel_proj", "linear_proj"):
        if getattr(mod, name, None) is not None:
            _fill_mlp(f, getattr(mod, name), p[name])
    if hasattr(mod, "downsampling"):
        cif, ds = mod.downsampling, p["downsampling"]
        if cif.cfg.produce_weight_type == "dense":
            f.linear(cif.dense_proj, ds["dense_proj"])
        else:
            for i, conv in enumerate(cif.convs()):
                f.conv1d(conv, ds[f"conv_{i}"])
        f.linear(cif.weight_proj, ds["weight_proj"])
        if hasattr(cif, "cif_output_proj"):
            f.linear(cif.cif_output_proj, ds["cif_output_proj"])
    if hasattr(mod, "head"):
        head, ph = mod.head, p["head"]
        _fill_mlp(f, head.linear_proj, ph["linear_proj"])
        if hasattr(head.vector_quantizer, "curr_temp"):  # `learnable=` VQ temperature
            f.put(head.vector_quantizer.curr_temp, ph["vector_quantizer"]["curr_temp"])
        if hasattr(head, "bn_layer"):
            f.norm(head.bn_layer, ph["bn_layer"])
            f.put(head.bn_layer.running_mean, stats["head"]["bn_layer"]["mean"])
            f.put(head.bn_layer.running_var, stats["head"]["bn_layer"]["var"])


def _finish(f: _Filler, *trees: _Tree) -> None:
    f.finish()
    unread = [p for t in trees for p in t.unread()]
    if unread:
        raise ValueError(f"JAX leaves the port does not read: {unread}")


def load_hubert(module: nn.Module, params: Dict) -> None:
    """Fill a `HubertModel` from the JAX `audio_encoder` params subtree."""
    f, p = _Filler(module), _Tree(params)
    _fill_hubert(f, module, p)
    _finish(f, p)


def load_mel_upstream(module: nn.Module, params: Dict) -> None:
    """Fill a `MelUpstream` from the JAX `MelUpstream` params (or a KWClip's
    `audio_encoder` subtree)."""
    f, p = _Filler(module), _Tree(params)
    _fill_mel(f, module, p)
    _finish(f, p)


def load_clip(module: nn.Module, params: Dict) -> None:
    """Fill a `ClipModel` from the JAX `clip` params subtree."""
    f, p = _Filler(module), _Tree(params)
    _fill_clip(f, module, p)
    _finish(f, p)


def load_jax_variables(model: nn.Module, variables: Dict) -> None:
    """Fill a `KWClip` from the JAX model's {'params', 'batch_stats'}."""
    p = _Tree(variables["params"], "params")
    stats = _Tree(variables.get("batch_stats", {}), "batch_stats")
    f = _Filler(model)
    f.put(model.weightedsum, p["weightedsum"])
    if hasattr(model, "criterion_log_inv_temp"):
        f.put(model.criterion_log_inv_temp, p["criterion_log_inv_temp"])
    _fill_audio(f, model.audio_encoder, p["audio_encoder"])
    _fill_clip(f, model.clip, p["clip"])
    for name in ("cascaded_branch", "parallel_branch"):
        if getattr(model, name) is not None:
            _fill_branch(f, getattr(model, name), p[name], stats.get(name, {}))
    for name in ("img_enc_proj_net", "p_branch_proj_net", "c_branch_proj_net"):
        if getattr(model, name) is not None:
            _fill_mlp(f, getattr(model, name), p[name])
    _finish(f, p, stats)
