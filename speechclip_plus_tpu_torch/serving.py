"""Batched inference + retrieval serving (port of ``speechclip_plus_tpu/serving.py``).

A device-resident, L2-normalized image index and the speech -> top-k query
(speech encode -> feature pick -> cosine scores -> top-k). Reference
anchors: retrieval scoring `avssl/model/kwClip.py:448-482`, feature choice
`retrieval.audio_feat_src`.

In JAX, XLA drops everything the chosen feature does not read
(`serving.py:114-127`). Eager PyTorch drops nothing, so the parallel query
calls `KWClip.encode_parallel` (tower + branch attention only) and the
cascaded query `encode_speech` (everything).

`submit` does not block: the padded batch is pinned, copied with
`non_blocking=True`, the query is enqueued behind it, and
`PendingSearch.done()` polls a CUDA event. Text queries (`search_text`,
JAX ``:132-168``) answer from the same index through CLIP's text tower; they
need the model's BPE tokenizer (`SpeechCLIP(..., tokenizer=...)`, or
`api.load_from_checkpoint` with the config's `bpe_path`).
"""
from __future__ import annotations

import itertools
from collections import deque
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .api import SpeechCLIP
from .utils.profiling import span

__all__ = ["RetrievalIndex", "SpeechRetriever", "PendingSearch", "build_image_index"]


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-8)


class RetrievalIndex:
    """Device-resident L2-normalized (N, E) fp32 image embeddings + ids."""

    def __init__(self, feats: torch.Tensor, ids: Sequence[int]):
        if feats.ndim != 2 or len(ids) != feats.shape[0]:
            raise ValueError(f"feats {tuple(feats.shape)} vs {len(ids)} ids")
        self.feats = _l2_normalize(feats)
        self.ids = np.asarray(ids)

    def __len__(self) -> int:
        return int(self.feats.shape[0])


@torch.inference_mode()
def build_image_index(speechclip: SpeechCLIP, images, ids: Sequence[int],
                      batch_size: int = 256) -> RetrievalIndex:
    """Embed (N, H, W, 3) preprocessed images (numpy or torch) through the
    frozen image tower in batches; duplicate ids should be deduped by the
    caller (the reference keeps one image per id)."""
    model, dev = speechclip.model, speechclip.device
    feats = []
    for i in range(0, images.shape[0], batch_size):
        chunk = torch.as_tensor(images[i: i + batch_size]).to(dev, torch.float32)
        feats.append(model.encode_image_raw(chunk).float())
    return RetrievalIndex(torch.cat(feats), ids)


class PendingSearch:
    """Handle for an in-flight retrieval query."""

    def __init__(self, index: RetrievalIndex, scores: torch.Tensor, idx: torch.Tensor,
                 keep_alive=(), request: Optional[int] = None):
        self._index, self._scores, self._idx = index, scores, idx
        self._keep_alive = keep_alive  # pinned host buffers of the upload
        self._request = request  # the id the query's spans carry
        self._event = None
        if scores.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record()

    def done(self) -> bool:
        """Non-blocking completion poll."""
        return self._event is None or self._event.query()

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        """Block until the query finishes; returns (ids, scores), each (B, k)."""
        with span("serve.wait", request=self._request):
            if self._event is not None:
                self._event.synchronize()
        with span("serve.d2h", request=self._request):
            self._keep_alive = ()
            return self._index.ids[self._idx.cpu().numpy()], self._scores.cpu().numpy()


class SpeechRetriever:
    """Speech -> top-k image retrieval."""

    def __init__(self, speechclip: SpeechCLIP, index: RetrievalIndex,
                 feat_src: Optional[str] = None):
        if feat_src is None:
            feat_src = speechclip.cfg.retrieval_audio_feat_src
        if feat_src not in ("parallel", "cascaded"):
            raise ValueError(f"unknown feat_src {feat_src!r}")
        cfg = speechclip.cfg
        has = {"cascaded": cfg.has_cascaded,
               "parallel": not cfg.has_cascaded or cfg.branch_type.startswith("Hybrid")}
        if not has[feat_src]:
            raise ValueError(f"feat_src {feat_src!r}: this model ({cfg.branch_type or 'parallel'}"
                             f" branch) has no {feat_src} feature")
        self.sc, self.index, self.feat_src = speechclip, index, feat_src
        self._requests = itertools.count()  # each query batch's id in the spans
        self._text_processor = None
        if speechclip.tokenizer is not None:
            from .data.tokenizer import ClipTextProcessor

            self._text_processor = ClipTextProcessor(speechclip.tokenizer, speechclip.vocab)

    @torch.inference_mode()
    def search_text(self, texts: Sequence[str], k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k image ids + cosine scores per text query, each (B, k): the
        CLIP text tower on the token ids (reduced ids when the model carries
        a reduced vocabulary) against the same index as speech queries."""
        if self._text_processor is None:
            raise ValueError(
                "text queries need a tokenizer: load the model via "
                "api.load_from_checkpoint with the config's bpe_path, or "
                "construct SpeechCLIP(..., tokenizer=..., vocab=...)"
            )
        k = min(int(k), len(self.index))
        ids = self._text_processor.prep_text(list(texts),
                                             context_length=self.sc.cfg.clip.context_length)
        ids = torch.from_numpy(np.asarray(ids, np.int64)).to(self.sc.device)
        scores = _l2_normalize(self.sc.model.clip.encode_text(ids)) @ self.index.feats.T
        top_scores, top_idx = torch.topk(scores, k, dim=-1)
        return self.index.ids[top_idx.cpu().numpy()], top_scores.cpu().numpy()

    def search(self, wavs: Sequence[np.ndarray], k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k image ids + cosine scores per waveform (ragged float32 or
        int16 PCM input)."""
        return self.submit(wavs, k).result()

    @torch.inference_mode()
    def submit(self, wavs: Sequence[np.ndarray], k: int = 10) -> PendingSearch:
        """Enqueue a query batch without waiting for the device."""
        request = next(self._requests)
        with span("serve.submit", request=request):
            k = min(int(k), len(self.index))
            wav, wav_len, host = self.sc.to_device(wavs, non_blocking=True)
            model = self.sc.model
            with span("serve.encode"):
                if self.feat_src == "parallel":
                    feat = model.encode_parallel(wav, wav_len)
                else:
                    feat = model.encode_speech(wav, wav_len)["cascaded_audio_feat"]
            with span("serve.score"):
                scores = _l2_normalize(feat) @ self.index.feats.T          # (B, N) cosines
                top_scores, top_idx = torch.topk(scores, k, dim=-1)
            return PendingSearch(self.index, top_scores, top_idx, keep_alive=host,
                                 request=request)

    def search_stream(self, batches, k: int = 10, depth: int = 2):
        """Pipelined bulk retrieval: yields (ids, scores) per input batch, in
        order, with up to `depth` query batches in flight."""
        pending: deque = deque()
        for wavs in batches:
            while len(pending) >= depth:
                yield pending.popleft().result()
            pending.append(self.submit(wavs, k))
        while pending:
            yield pending.popleft().result()
