"""Plain PyTorch reference of a WavLM tower (arXiv:2110.13900) under the
SpeechCLIP(+) branches, and of training steps with gradient accumulation.

`WavLM` is `reference.model.Model` with the tower's self-attention replaced:
every score of layer l, head h, query i and key j takes

    gate_l[b, h, i] * table[bucket(j - i), h]

added to the scaled q·k and the key padding, where `bucket` is the T5 /
WavLM bucketing below (half the buckets for each sign of j - i, distances
under a quarter of the buckets one to one, larger ones log-spaced up to
`rel_max_distance` and clipped to the last bucket of their half), `table` the
tower's one relative-position table (buckets, H), gathered once per length,
and the gate WavLM's per-layer GRU-style gate computed from the layer's
attention input x split per head (B, H, T, dh):

    a, b = sigmoid(sum over 2 groups of 4 of (x_h W_l^T + c_l)), one of each per row
    gate = a * (b * k_l - 1) + 2

with W_l (8, dh), c_l (8,) and k_l one scale a head. The branch, CIF, the
keyword head, the text tower and the loss are `Model`'s. Float32 with TF32
off, in blocks of rows; it imports nothing of the measured program.

Departures from the published description, each the measured program's
documented choice and part of what is compared:
  - the attention weights are dropped with the counter mask of ``rng.py``
    (one (seed, offset) pair a layer), the program's, not torch's dropout;
  - the bucket's log ratio is a float32 log divided by the float32 log of
    max_distance / max_exact and truncated toward zero;
  - the waveform is not layer-normed here (WavLM Large's `normalize`): the
    program leaves that to its dataset, and the benchmark hands it crops.

`WavLM(..., gate=False)` (the ungated bias, every gate 1) and `bias=False`
(no relative bias at all) are the planted faults of the control.

`accumulated_steps` runs the first optimizer steps of a configuration with
`accumulate_grad_batches` > 1: each micro-step its own batch and dropout
stream (the generator of micro-step s), the gradients of a window averaged
before the clip and Adam, the learning rate and CIF's schedule read at the
optimizer step.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .model import Model, Prec
from .rng import bernoulli_keep, draw_seed, keep_mask, step_generator
from .train import lr_at, trainable_names

__all__ = ["buckets", "WavLM", "accumulated_steps"]

_TOWER = "audio_encoder."


def buckets(t: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    """(T, T) int64: the bucket of key j relative to query i, j - i."""
    pos = torch.arange(t, dtype=torch.long)
    rel = pos[None, :] - pos[:, None]
    half = num_buckets // 2
    out = (rel > 0).long() * half
    dist = rel.abs()
    exact = half // 2
    scaled = torch.log(dist.float() / exact) / math.log(max_distance / exact) * (half - exact)
    far = torch.clamp(exact + scaled.long(), max=half - 1)
    return out + torch.where(dist < exact, dist, far)


class WavLM(Model):
    """`Model` with WavLM's gated relative position bias in every tower layer."""

    def __init__(self, W: Dict[str, torch.Tensor], arch: dict, prec: Prec, row_block: int = 32,
                 gate: bool = True, bias: bool = True):
        super().__init__(W, arch, prec, row_block)
        self.use_gate, self.use_bias = gate, bias
        self._tables, self._gen = {}, None

    def table(self, t: int) -> torch.Tensor:
        """(H, T, T): the relative-position table gathered at length T."""
        if t not in self._tables:
            A = self.a["audio"]
            idx = buckets(t, A["rel_buckets"], A["rel_max_distance"])
            emb = self.W[_TOWER + "rel_attn_embed"]
            self._tables = {t: emb[idx.to(emb.device)].permute(2, 0, 1).contiguous()}
        return self._tables[t]

    def gate(self, x: torch.Tensor, layer: str) -> torch.Tensor:
        """(B, H, T): layer `layer`'s gate from its attention input x (B, T, D)."""
        W, heads = self.W, self.a["audio"]["n_heads"]
        b, t, d = x.shape
        xh = x.reshape(b, t, heads, d // heads).transpose(1, 2)
        proj = self.p.linear(xh, W[layer + "gru_rel_pos_linear.weight"],
                             W[layer + "gru_rel_pos_linear.bias"])
        a, g = torch.sigmoid(proj.reshape(b, heads, t, 2, 4).sum(-1)).unbind(-1)
        return a * (g * W[layer + "gru_rel_pos_const"].reshape(1, heads, 1) - 1.0) + 2.0

    def speech_features(self, wav, wav_len, *, train=False, gen=None, **kw):
        self._gen = gen if train else None  # the keyword projection's dropout draws from it
        return super().speech_features(wav, wav_len, train=train, gen=gen, **kw)

    def _keyword_head(self, x, train, fixed_k, forced=None):
        """`Model`'s head, with the large branch's keyword projection where the
        configuration has one (`kw_projection`: Linear, ReLU and dropout
        between layers, the dropout drawn from the micro-step's generator
        after CIF's), followed by the head's BatchNorm and VQ."""
        W, P = self.W, self.p
        pre = "cascaded_branch.head."
        if pre + "linear_proj.weight" in W:
            return super()._keyword_head(x, train, fixed_k, forced)
        i, y = 0, x
        while f"{pre}linear_proj.layers.{i}.weight" in W:
            if i:
                y = torch.relu(y)
                if train and self._gen is not None:
                    y = y * bernoulli_keep(y.shape, self.a["branch"]["kw_projection_dropout"],
                                           self._gen)
            y = P.linear(y, W[f"{pre}linear_proj.layers.{i}.weight"],
                         W[f"{pre}linear_proj.layers.{i}.bias"])
            i += 1
        # the head past its projection, with an identity projection in its
        # place (exact in float32; the fp8 control rounds the rows once more)
        d = y.shape[-1]
        W[pre + "linear_proj.weight"] = torch.eye(d, device=y.device)
        W[pre + "linear_proj.bias"] = torch.zeros(d, device=y.device)
        try:
            return super()._keyword_head(y, train, fixed_k, forced)
        finally:
            del W[pre + "linear_proj.weight"], W[pre + "linear_proj.bias"]

    def self_attention(self, x, pre, heads, key_bias, gen=None, p_drop=0.0, mask=None):
        if not (pre.startswith(_TOWER + "layers.") and self.use_bias):
            return super().self_attention(x, pre, heads, key_bias, gen, p_drop, mask)
        W, P = self.W, self.p
        b, t, d = x.shape
        dh = d // heads
        layer = pre[: -len("self_attn.")]
        rel = self.table(t)
        gate = self.gate(x, layer) if self.use_gate else x.new_ones(b, heads, t)
        qkv = P.linear(x, W[pre + "in_proj_weight"], W[pre + "in_proj_bias"])
        q, k, v = (a.reshape(b, t, heads, dh).transpose(1, 2) for a in qkv.split(d, dim=-1))
        q = q * dh ** -0.5
        pair = draw_seed(gen) if gen is not None and p_drop > 0 else None
        out = []
        for b0 in range(0, b, self.rb):
            b1 = min(b, b0 + self.rb)
            s = P.matmul(q[b0:b1], k[b0:b1].transpose(-1, -2))
            s = s + gate[b0:b1, :, :, None] * rel[None]
            if key_bias is not None:
                s = s + key_bias[b0:b1, None, None, :]
            w = torch.softmax(s, dim=-1)
            if pair is not None:
                keep = keep_mask(pair, b0, b1, heads, t, 1.0 - p_drop, x.device)
                w = torch.where(keep, w / (1.0 - p_drop), 0.0)
            out.append(P.matmul(w, v[b0:b1]))
        ctx = torch.cat(out).transpose(1, 2).reshape(b, t, d)
        return P.linear(ctx, W[pre + "out_proj.weight"], W[pre + "out_proj.bias"])


def accumulated_steps(model: Model, batches, seed: int, optim: dict, n_steps: int,
                      accum: int, fault: str = None, forced=None) -> dict:
    """`n_steps` optimizer steps of `accum` micro-steps each, from the weights
    in `model.W` (updated in place), micro-step s on `batches[s]`. Returns
    what `reference.train.reference_steps` returns, with 'loss' and 'chosen'
    one a micro-step and 'grad' / 'raw_grad' the first optimizer step's
    (the mean over its micro-steps, clipped with its decay term as Adam's
    first moment gives it / unclipped). `forced` one (B * K,) tensor a
    micro-step; `fault` "half" as in `reference_steps`."""
    W = model.W
    names = trainable_names(W)
    start = {n: W[n].detach().clone() for n in names}
    m = {n: torch.zeros_like(W[n]) for n in names}
    v = {n: torch.zeros_like(W[n]) for n in names}
    b1, b2, eps = 0.9, 0.999, 1e-8
    wd, clip = float(optim["weight_decay"]), float(optim["gradient_clip_val"])
    out = {"loss": [], "start": start, "chosen": []}
    dev = W[names[0]].device
    for s in range(n_steps):
        total = None
        for j in range(accum):
            micro = s * accum + j
            batch = batches[micro]
            for n in names:
                W[n] = W[n].detach().requires_grad_(True)
            feats = model.speech_features(
                batch["wav"], batch["wav_len"], train=True, gen=step_generator(seed, micro, dev),
                step=s, forced=None if forced is None else forced[micro])
            out["chosen"].append(model.chosen)
            rows = batch["id"].shape[0] // 2 if fault == "half" else batch["id"].shape[0]
            feats = {k: t[:rows] for k, t in feats.items()}
            loss = model.loss(feats, batch["image_feat"][:rows], batch["id"][:rows])
            grads = torch.autograd.grad(loss, [W[n] for n in names], allow_unused=True)
            grads = [torch.zeros_like(W[n]) if g is None else g.detach()
                     for n, g in zip(names, grads)]
            total = grads if total is None else [a + g for a, g in zip(total, grads)]
            out["loss"].append(float(loss.detach()))
            del feats, loss, grads
        with torch.no_grad():
            grads = [g / accum for g in total]
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.clamp(clip / norm, max=1.0) if clip > 0 else 1.0
            lr = lr_at(optim, s)
            bc1, bc2 = 1.0 - b1 ** (s + 1), 1.0 - b2 ** (s + 1)
            for n, g in zip(names, grads):
                p = W[n].detach()
                g = g * scale + wd * p
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = v[n].sqrt() / bc2 ** 0.5 + eps
                W[n] = p - (lr / bc1) * m[n] / denom
            if s == 0:
                out["grad"] = {n: m[n] / (1 - b1) for n in names}
                out["raw_grad"] = dict(zip(names, grads))
        del total, grads
    for n in names:
        W[n] = W[n].detach()
    if forced is not None:
        out["kw_gap"] = model.kw_gap
    return out
