"""Text metrics: token/word/phone/char error rates and BLEU.

A copy of ``speechclip_plus_tpu/utils/metric.py`` (plain numpy). Reference: ``avssl/util/metric.py:7-77`` — TER/WER/PER/CER via editdistance
and corpus BLEU via sacrebleu. Neither dependency is available here, so both
are implemented directly: Levenshtein distance as a vectorized numpy DP, and
corpus BLEU-4 with the standard brevity penalty (sacrebleu's default
tokenization is whitespace here since inputs are already-normalized
captions).
"""
from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence

import numpy as np

__all__ = ["edit_distance", "ter", "wer", "per", "cer", "report_bleu"]


def edit_distance(hyp: Sequence, ref: Sequence) -> int:
    """Levenshtein distance via a rolling numpy DP row."""
    if len(hyp) == 0:
        return len(ref)
    if len(ref) == 0:
        return len(hyp)
    hyp_arr = np.asarray([hash(t) for t in hyp])
    prev = np.arange(len(hyp_arr) + 1)
    idx = np.arange(1, len(prev))
    for j, r in enumerate(ref, start=1):
        # substitution / insertion are vectorized; the deletion recurrence
        # cur[i] = min(cur[i], cur[i-1]+1) is a prefix-min of (cur[i] - i)
        cur = np.empty_like(prev)
        cur[0] = j
        cur[1:] = np.minimum(prev[:-1] + (hyp_arr != hash(r)), prev[1:] + 1)
        cur[1:] = np.minimum.accumulate(
            np.concatenate(([cur[0]], cur[1:] - idx))
        )[1:] + idx
        prev = cur
    return int(prev[-1])


def ter(hyps: List[Sequence], refs: List[Sequence]) -> float:
    """Token error rate = sum(edit distance) / sum(ref lengths)
    (reference `metric.py` ter)."""
    assert len(hyps) == len(refs)
    err = sum(edit_distance(h, r) for h, r in zip(hyps, refs))
    total = sum(len(r) for r in refs)
    return err / max(total, 1)


def wer(hyps: List[str], refs: List[str]) -> float:
    return ter([h.split() for h in hyps], [r.split() for r in refs])


def per(hyps: List[str], refs: List[str]) -> float:
    """Phone error rate (same computation as WER on phone strings)."""
    return wer(hyps, refs)


def cer(hyps: List[str], refs: List[str]) -> float:
    return ter([list(h) for h in hyps], [list(r) for r in refs])


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def report_bleu(hyps: List[str], refs: List[str], max_n: int = 4) -> float:
    """Corpus BLEU-N with brevity penalty (x100)."""
    assert len(hyps) == len(refs)
    clipped = np.zeros(max_n)
    totals = np.zeros(max_n)
    hyp_len = ref_len = 0
    for hyp, ref in zip(hyps, refs):
        h, r = hyp.split(), ref.split()
        hyp_len += len(h)
        ref_len += len(r)
        for n in range(1, max_n + 1):
            hc, rc = _ngrams(h, n), _ngrams(r, n)
            totals[n - 1] += max(len(h) - n + 1, 0)
            clipped[n - 1] += sum(min(c, rc[g]) for g, c in hc.items())
    valid = totals > 0  # effective order: ignore n longer than every hyp
    if not valid.any():
        return 0.0
    precisions = clipped[valid] / totals[valid]
    precisions = np.maximum(precisions, 1e-9)  # exp smoothing for 0 matches
    log_p = np.mean(np.log(precisions))
    bp = 1.0 if hyp_len > ref_len else math.exp(1.0 - ref_len / max(hyp_len, 1))
    return float(100.0 * bp * math.exp(log_p))
