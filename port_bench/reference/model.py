"""Plain PyTorch reference of the SpeechCLIP(+) models the benchmark runs.

Written from the published descriptions (fairseq HuBERT base and large,
OpenAI CLIP, the SpeechCLIP and SpeechCLIP+ branches of
arXiv:2210.00705 and arXiv:2402.06959), in float32 with TF32 off, with no
kernel, cache or batching of the measured program. It imports nothing of the
program: it reads the weights the benchmark made (a dict keyed by the
program's parameter names) and the configuration's `arch` sizes.

Departures from the papers, each the measured program's documented choice
and part of what is compared:
  - dropout draws come from the step generator in the program's order
    (``rng.py``), so the masks agree;
  - CIF is the bin-overlap form of integrate-and-fire: keyword slot t takes
    from frame s the overlap of the frame's cumulative-alpha interval with
    [t, t + 1), the last slot open above; its alpha head drops at 0.5;
  - the vector quantizer is the hard argmax over cosine scores, special ids
    0, 2 and 3 excluded, with the straight-through softmax gradient at its
    temperature.

`Prec` decides the arithmetic of every matrix product and convolution:
float32, or (the control) each operand rounded to float8 e4m3 first.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .rng import bernoulli_keep, draw_seed, keep_mask

__all__ = ["Prec", "Model"]

_NEG = -1e30


class Prec:
    """Operand rounding of the products: "fp32" (none) or "fp8" (e4m3 with a
    power-of-two scale per tensor)."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"precision {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return x
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = torch.exp2(torch.floor(torch.log2(448.0 / amax)))
        y = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
        return x + (y - x).detach()

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))

    def conv1d(self, x, w, b=None, **kw):
        return F.conv1d(self.q(x), self.q(w), b, **kw)

    def conv2d(self, x, w, **kw):
        return F.conv2d(self.q(x), self.q(w), **kw)


def _ln(x, w, b, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def _l2n(x, eps=1e-12):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(eps)


class Model:
    """The reference model over weights `W` (float32 on one device)."""

    def __init__(self, W: Dict[str, torch.Tensor], arch: dict, prec: Prec, row_block: int = 32):
        self.W, self.a, self.p, self.rb = W, arch, prec, row_block
        self.chosen, self.kw_gap = None, 0.0

    # ---------------------------------------------------------------- attention --
    def self_attention(self, x, pre: str, heads: int, key_bias, gen=None, p_drop=0.0,
                       mask=None):
        """softmax(q kᵀ / sqrt(dh) + biases) v, dropped per the program's
        counter mask, then the out-projection. x (B, T, D); key_bias (B, T)
        additive or None; mask (T, T) additive or None."""
        W, P = self.W, self.p
        b, t, d = x.shape
        dh = d // heads
        qkv = P.linear(x, W[pre + "in_proj_weight"], W[pre + "in_proj_bias"])
        q, k, v = (a.reshape(b, t, heads, dh).transpose(1, 2) for a in qkv.split(d, dim=-1))
        q = q * dh ** -0.5
        pair = draw_seed(gen) if gen is not None and p_drop > 0 else None
        out = []
        for b0 in range(0, b, self.rb):
            b1 = min(b, b0 + self.rb)
            s = P.matmul(q[b0:b1], k[b0:b1].transpose(-1, -2))
            if key_bias is not None:
                s = s + key_bias[b0:b1, None, None, :]
            if mask is not None:
                s = s + mask
            w = torch.softmax(s, dim=-1)
            if pair is not None:
                keep = keep_mask(pair, b0, b1, heads, t, 1.0 - p_drop, x.device)
                w = torch.where(keep, w / (1.0 - p_drop), 0.0)
            out.append(P.matmul(w, v[b0:b1]))
        ctx = torch.cat(out).transpose(1, 2).reshape(b, t, d)
        return P.linear(ctx, W[pre + "out_proj.weight"], W[pre + "out_proj.bias"])

    # -------------------------------------------------------------------- tower --
    def _frontend(self, wav):
        """Waveform (b, T) -> frames (b, T', C): the strided conv stack."""
        W, P, A = self.W, self.p, self.a["audio"]
        pre = "audio_encoder.feature_extractor."
        x = wav[:, None, :]
        for i, (_c, _k, s) in enumerate(A["conv_layers"]):
            bias = W.get(f"{pre}conv_layers.{i}.bias")
            x = P.conv1d(x, W[f"{pre}conv_layers.{i}.weight"], bias, stride=s)
            if A["extractor_mode"] == "layer_norm":
                x = _ln(x.transpose(1, 2), W[f"{pre}layer_norms.{i}.weight"],
                        W[f"{pre}layer_norms.{i}.bias"]).transpose(1, 2)
            elif i == 0:
                x = F.group_norm(x, x.shape[1], W[pre + "gn.weight"], W[pre + "gn.bias"], 1e-5)
            x = F.gelu(x)
        return x.transpose(1, 2)

    def tower(self, wav, wav_len, gen=None, train: bool = False):
        """The frozen acoustic tower and its softmax-weighted sum of hidden
        states: (feat (B, T', D), feat_len (B,)). The sum takes gradients
        into the layer weights alone."""
        W, P, A = self.W, self.p, self.a["audio"]
        pre = "audio_encoder."
        p = A["dropout"] if train else 0.0
        g = gen if train else None
        with torch.no_grad():
            feats = torch.cat([self._frontend(wav[i: i + self.rb])
                               for i in range(0, wav.shape[0], self.rb)])
            b, t, _ = feats.shape
            wav_pad = torch.arange(wav.shape[1], device=wav.device)[None] >= wav_len[:, None]
            n = wav.shape[1] - wav.shape[1] % t
            pad = wav_pad[:, :n].reshape(b, t, -1).all(dim=-1)
            x = _ln(feats, W[pre + "layer_norm.weight"], W[pre + "layer_norm.bias"])
            if pre + "post_extract_proj.weight" in W:
                x = P.linear(x, W[pre + "post_extract_proj.weight"],
                             W[pre + "post_extract_proj.bias"])
            if g is not None:
                x = x * bernoulli_keep(x.shape, p, g)
            x = x.masked_fill(pad[:, :, None], 0.0)
            k = A["conv_pos"]
            pc = P.conv1d(x.transpose(1, 2), W[pre + "pos_conv.conv.weight"],
                          W[pre + "pos_conv.conv.bias"], padding=k // 2,
                          groups=A["conv_pos_groups"])
            if k % 2 == 0:
                pc = pc[:, :, :-1]
            x = x + F.gelu(pc).transpose(1, 2)
            if not A["layer_norm_first"]:
                x = _ln(x, W[pre + "encoder_layer_norm.weight"],
                        W[pre + "encoder_layer_norm.bias"])
            if g is not None:
                x = x * bernoulli_keep(x.shape, p, g)
            key_bias = torch.where(pad, _NEG, 0.0)
            norm = (lambda h: F.layer_norm(h, h.shape[-1:])) if A["normalize_contrib"] \
                else (lambda h: h)
            hidden = [norm(x)]
            for i in range(A["n_layers"]):
                lp = f"{pre}layers.{i}."
                ln1 = (W[lp + "self_attn_layer_norm.weight"], W[lp + "self_attn_layer_norm.bias"])
                ln2 = (W[lp + "final_layer_norm.weight"], W[lp + "final_layer_norm.bias"])
                ffn = lambda h: P.linear(F.gelu(P.linear(h, W[lp + "fc1.weight"],
                                                         W[lp + "fc1.bias"])),
                                         W[lp + "fc2.weight"], W[lp + "fc2.bias"])
                drop = (lambda h: h * bernoulli_keep(h.shape, p, g)) if g is not None \
                    else (lambda h: h)
                if A["layer_norm_first"]:
                    a = self.self_attention(_ln(x, *ln1), lp + "self_attn.", A["n_heads"],
                                            key_bias, g, A["attention_dropout"] if train else 0)
                    x = x + drop(a)
                    x = x + drop(ffn(_ln(x, *ln2)))
                else:
                    a = self.self_attention(x, lp + "self_attn.", A["n_heads"], key_bias, g,
                                            A["attention_dropout"] if train else 0)
                    x = _ln(x + drop(a), *ln1)
                    x = _ln(x + drop(ffn(x)), *ln2)
                hidden.append(norm(x))
        wts = torch.softmax(W["weightedsum"], dim=0)
        feat = sum(wts[i] * h for i, h in enumerate(hidden))
        feat_len = torch.clamp(torch.round(wav_len.float() / A["downsample_rate"]).long(), max=t)
        return feat, feat_len

    # ------------------------------------------------------------------- branch --
    def _branch_attention(self, feat, feat_len, cls, heads, gen, train):
        """[cls; frames] through one attention + residual + LayerNorm block."""
        W = self.W
        pre = "cascaded_branch.self_att."
        b, t, d = feat.shape
        kk = cls.shape[1]
        src = torch.cat([cls.expand(b, kk, d), feat], dim=1)
        pad = torch.arange(t + kk, device=feat.device)[None] >= (feat_len + kk)[:, None]
        a = self.self_attention(src, pre + "multihead_attn_layer.", heads,
                                torch.where(pad, _NEG, 0.0), gen if train else None,
                                self.a["branch"]["dropout"] if train else 0.0)
        out = _ln(a + src, W[pre + "attentionBlock_Norm.weight"],
                  W[pre + "attentionBlock_Norm.bias"], self.a["branch"]["layer_norm_eps"])
        return out, pad

    def _cif(self, frames, pad, feat_len, step, gen, train):
        """Alpha head and integrate-and-fire: (slots (B, S, D), slot count (B,),
        alpha sum before scaling (B,), target count (B,))."""
        W, P, C = self.W, self.p, self.a["cif"]
        pre = "cascaded_branch.downsampling."
        x = P.conv1d(frames.transpose(1, 2), W[pre + "conv.weight"], W[pre + "conv.bias"],
                     padding=C["conv_width"] // 2)
        if train:
            x = torch.relu(x * bernoulli_keep(x.shape, 0.5, gen))
            x = x * bernoulli_keep(x.shape, 0.5, gen)
        else:
            x = torch.relu(x)
        alpha = torch.sigmoid(F.linear(x.transpose(1, 2), W[pre + "weight_proj.weight"],
                                       W[pre + "weight_proj.bias"]))[..., 0]
        alpha = alpha.masked_fill(pad, 0.0)
        quantity = alpha.sum(dim=1)
        target = torch.round(feat_len.float() / 20.0).long()
        thr, slots = C["threshold"], C["max_slots"]
        if train and step < C["scaling_step"]:
            alpha = alpha * (thr * target.float() + 1e-5)[:, None] / \
                alpha.sum(dim=1, keepdim=True).clamp_min(1e-12)
        total = alpha.sum(dim=1)
        csum = torch.cumsum(alpha, dim=1)
        edges = torch.arange(slots + 1, device=frames.device, dtype=torch.float32) * thr
        hi = torch.minimum(csum[:, None, :], edges[None, :, None] + thr)
        hi = torch.cat([hi[:, :slots], csum[:, None, :]], dim=1)   # the last slot is open
        lo = torch.maximum((csum - alpha)[:, None, :], edges[None, :, None])
        weight = torch.clamp(hi - lo, min=0.0)                     # (B, slots + 1, S)
        count = torch.clamp(torch.floor(total / thr).long(), 1, slots)
        out = torch.bmm(weight, frames)[:, :slots]
        if not train:  # tail: fire once more on a residue of at least the tail threshold
            tail = weight.sum(dim=2).gather(1, count[:, None])[:, 0]
            extend = tail >= C["tail_threshold"]
            up = torch.where(extend, thr / tail.clamp_min(1e-12), 1.0)
            full = torch.bmm(weight, frames)
            at = torch.arange(slots + 1, device=frames.device)[None] == count[:, None]
            full = full * torch.where(at, up[:, None], 1.0)[:, :, None]
            count = torch.clamp(count + extend.long(), 1, slots)
            live = torch.arange(slots, device=frames.device)[None] < count[:, None]
            out = full[:, :slots] * live[:, :, None]
        return out, count, quantity, target

    def _keyword_head(self, x, train, fixed_k: Optional[int], forced=None):
        """Projection, keyword BatchNorm (batch statistics in training),
        cosine scores against the token table, hard VQ: keywords (.., D_text).
        `forced` (B * K,) takes those codes in place of the argmax (the
        program's choices, judged by `self.kw_gap`); `self.chosen` keeps the
        codes taken."""
        W, P = self.W, self.p
        pre = "cascaded_branch.head."
        y = P.linear(x, W[pre + "linear_proj.weight"], W[pre + "linear_proj.bias"])
        b, kk, d = y.shape
        gamma, beta = W[pre + "bn_layer.weight"], W[pre + "bn_layer.bias"]
        if fixed_k is None:  # one BatchNorm over D across every slot
            rows = y.reshape(b * kk, d)
        else:  # one BatchNorm per keyword and dimension, channel d * K + k
            rows = y.transpose(1, 2).reshape(b, d * kk)
        if train:
            mean, var = rows.mean(dim=0), rows.var(dim=0, unbiased=False)
        else:
            mean = W[pre + "bn_layer.running_mean"]
            var = W[pre + "bn_layer.running_var"]
        rows = (rows - mean) * torch.rsqrt(var + 1e-5) * gamma + beta
        y = rows.reshape(b, kk, d) if fixed_k is None else \
            rows.reshape(b, d, kk).transpose(1, 2)
        emb = W["clip.text.token_embedding.weight"]
        xn = y / y.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        en = emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        s = P.matmul(xn.reshape(b * kk, d), en.T)
        s[:, list(self.a["vq"]["masked_ids"])] = _NEG
        best = s.argmax(dim=-1)
        if forced is not None:
            live = s.detach()
            gap = live.max(dim=-1).values - live.gather(1, forced[:, None])[:, 0]
            self.kw_gap = max(self.kw_gap, float(gap.max()))
            best = forced
        self.chosen = best.detach()
        hard = emb[best]
        if train:
            soft = torch.softmax(s / self.a["vq"]["temperature"], dim=-1) @ emb
            hard = hard + soft - soft.detach()
        return hard.reshape(b, kk, -1)

    # --------------------------------------------------------------------- CLIP --
    def _clip_blocks(self, x, pre, n, heads, mask=None):
        W, P = self.W, self.p
        for i in range(n):
            bp = f"{pre}blocks.{i}."
            h = _ln(x, W[bp + "ln_1.weight"], W[bp + "ln_1.bias"])
            x = x + self.self_attention(h, bp + "attn.", heads, None, mask=mask)
            h = _ln(x, W[bp + "ln_2.weight"], W[bp + "ln_2.bias"])
            h = P.linear(h, W[bp + "c_fc.weight"], W[bp + "c_fc.bias"])
            x = x + P.linear(h * torch.sigmoid(1.702 * h), W[bp + "c_proj.weight"],
                             W[bp + "c_proj.bias"])
        return x

    def encode_keywords(self, keywords, count):
        """The CLIP text tower over [SOT, keywords, EOT, 0 ...], pooled at EOT."""
        W, C = self.W, self.a["clip"]
        b, kmax, _ = keywords.shape
        ctx = C["context_length"]
        emb = W["clip.text.token_embedding.weight"]
        eot = count.clamp(1, ctx - 2) + 1
        pos = torch.arange(ctx, device=keywords.device)[None, :]
        ids = torch.where(pos == 0, C["sot_id"], 0)
        ids = torch.where(pos == eot[:, None], C["eot_id"], ids)
        x = emb[ids]
        kw = keywords[:, (pos[0] - 1).clamp(0, kmax - 1), :]
        x = torch.where(((pos >= 1) & (pos < eot[:, None]))[:, :, None], kw, x)
        x = x + W["clip.text.positional_embedding"]
        causal = torch.full((ctx, ctx), _NEG, device=x.device).triu(1)
        x = self._clip_blocks(x, "clip.text.transformer.", C["text_layers"], C["text_heads"],
                              causal)
        x = _ln(x, W["clip.text.ln_final.weight"], W["clip.text.ln_final.bias"])
        pooled = x[torch.arange(b, device=x.device), eot]
        return self.p.matmul(pooled, W["clip.text.text_projection"])

    def encode_images(self, images):
        """Images (N, H, W, 3) -> raw CLIP image features (N, E), in blocks."""
        W, C, P = self.W, self.a["clip"], self.p
        out = []
        for i in range(0, images.shape[0], 4 * self.rb):
            img = images[i: i + 4 * self.rb].permute(0, 3, 1, 2)
            ps = C["patch_size"]
            x = P.conv2d(img, W["clip.visual.conv1.weight"], stride=ps)
            x = x.flatten(2).transpose(1, 2)
            cls = W["clip.visual.class_embedding"].expand(x.shape[0], 1, -1)
            x = torch.cat([cls, x], dim=1) + W["clip.visual.positional_embedding"]
            x = _ln(x, W["clip.visual.ln_pre.weight"], W["clip.visual.ln_pre.bias"])
            x = self._clip_blocks(x, "clip.visual.transformer.", C["vision_layers"],
                                  C["vision_heads"])
            x = _ln(x[:, 0], W["clip.visual.ln_post.weight"], W["clip.visual.ln_post.bias"])
            out.append(P.matmul(x, W["clip.visual.proj"]))
        return torch.cat(out)

    # ------------------------------------------------------------------ features --
    def speech_features(self, wav, wav_len, *, train=False, gen=None, step=0,
                        want=("cascaded", "parallel"), forced=None):
        """The branch's outputs for a batch: {'cascaded': (B, E) or absent,
        'parallel': (B, E) or absent, 'quantity', 'target'}; `want` the
        features to compute (serving computes only the one it reads);
        `forced` the keyword codes to take (`_keyword_head`)."""
        A = self.a
        feat, feat_len = self.tower(wav, wav_len, gen, train)
        kind = A["branch"]["type"]
        heads = A["branch"]["heads"]
        out = {}
        if kind == "HybridBranch_plus":
            cls = self.W["cascaded_branch.cls"]
            h, pad = self._branch_attention(feat, feat_len, cls, heads, gen, train)
            if A["has_parallel"] and "parallel" in want:
                out["parallel"] = F.linear(h[:, 0], self.W["cascaded_branch.parallel_proj.weight"],
                                           self.W["cascaded_branch.parallel_proj.bias"])
            if A["has_cascaded"] and "cascaded" in want:
                slots, count, quantity, target = self._cif(h[:, 1:], pad[:, 1:], feat_len, step,
                                                           gen, train)
                kw = self._keyword_head(slots, train, None, forced)
                out["cascaded"] = self.encode_keywords(kw, count)
                out["quantity"], out["target"] = quantity, target
        elif kind == "CascadedBranch":
            cls = self.W["cascaded_branch.cls"]
            k = cls.shape[1]
            h, _ = self._branch_attention(feat, feat_len, cls, heads, gen, train)
            kw = self._keyword_head(h[:, :k], train, k, forced)
            out["cascaded"] = self.encode_keywords(kw, torch.full_like(feat_len, k))
        else:
            raise NotImplementedError(f"branch {kind!r}")
        return out

    def loss(self, feats, image_feat, ids):
        """Each objective's symmetric contrastive loss (captions of one image
        are no negatives of each other), weighted, plus the CIF count loss."""
        A = self.a
        img = _l2n(image_feat)
        scale = torch.exp(self.W["criterion_log_inv_temp"])
        b = img.shape[0]
        eye = torch.eye(b, dtype=torch.bool, device=img.device)
        neg = (ids[:, None] != ids[None, :]) | eye
        total = 0.0
        for key, weight in (("cascaded", A["cascaded_weight"]), ("parallel", A["parallel_weight"])):
            if weight <= 0 or key not in feats:
                continue
            logits = _l2n(feats[key]) @ img.T * scale
            pos = logits.diagonal()
            terms = []
            for dim in (1, 0):
                masked = torch.where(neg, logits, _NEG)
                terms.append((torch.logsumexp(masked, dim=dim) - pos).mean())
            total = total + weight * (terms[0] + terms[1]) / 2
        if "quantity" in feats:
            total = total + A["cif"]["quantity_loss_weight"] * \
                (feats["quantity"] - feats["target"].float()).abs().mean()
        return total

    def retrieval_feature(self, wav, wav_len, forced=None):
        """The feature serving scores; `forced` the keyword codes to take."""
        key = self.a["retrieval_feat"]
        return self.speech_features(wav, wav_len, want=(key,), forced=forced)[key]


def kw_bn_init(W: Dict[str, torch.Tensor], arch: dict) -> None:
    """Keyword BatchNorm scale and shift from the token table: the unbiased
    std and the mean of each dimension, repeated per keyword for the fixed-K
    per-keyword layout (channel d * K + k)."""
    emb = W["clip.text.token_embedding.weight"]
    std, mean = emb.std(dim=0), emb.mean(dim=0)
    k = arch["branch"].get("keywords")
    if k:
        std, mean = std.repeat_interleave(k), mean.repeat_interleave(k)
    W["cascaded_branch.head.bn_layer.weight"] = std.clone()
    W["cascaded_branch.head.bn_layer.bias"] = mean.clone()
    W["cascaded_branch.head.bn_layer.running_mean"] = torch.zeros_like(std)
    W["cascaded_branch.head.bn_layer.running_var"] = torch.ones_like(std)


def log_inv_temp(temperature: float) -> torch.Tensor:
    return torch.tensor(math.log(1.0 / temperature))
