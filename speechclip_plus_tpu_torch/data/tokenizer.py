"""CLIP-compatible BPE tokenizer + reduced-vocabulary id mapping.

Port of ``speechclip_plus_tpu/data/tokenizer.py`` (numpy; a copy, since the
port imports nothing of the JAX package).

The reference uses `clip.simple_tokenizer.SimpleTokenizer` (BPE over a
16e6-merges vocabulary) and a usage-ranked reduced id set
(`avssl/module/clip_official.py:59,63-107`). This is an independent
implementation of the same tokenization scheme: lowercase, basic whitespace
cleanup, the CLIP word-piece regex, byte-level unicode mapping, and BPE
merges loaded from the standard `bpe_simple_vocab_16e6.txt.gz` file (path
supplied by the caller — the file ships with every CLIP checkpoint
distribution; tests use a tiny synthetic merge table).
"""
from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from typing import Dict, Iterable, List, Sequence

import numpy as np

__all__ = ["bytes_to_unicode", "SimpleTokenizer", "ReducedVocab", "ClipTextProcessor"]

CONTEXT_LENGTH = 77


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2/CLIP convention)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word) -> set:
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip()


class SimpleTokenizer:
    """CLIP BPE tokenizer (49152 merges + 256*2 byte tokens + SOT/EOT)."""

    # CLIP's original pattern uses \p{L}/\p{N} (regex module); stdlib `re`
    # has no unicode properties, so letters/digits are matched via str
    # methods through these ASCII classes plus the unicode fallback group -
    # identical on the English Flickr8k/SpokenCOCO captions.
    WORD_PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[^\W\d_]+|\d|[^\s\w]+|_""",
        re.IGNORECASE | re.UNICODE,
    )

    def __init__(self, bpe_path: str):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder: Dict[str, int] = {v: i for i, v in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: v for v, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _clean(text).lower()
        for token in re.findall(self.WORD_PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder.get(ch, 0) for ch in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def tokenize(
        self, texts, context_length: int = CONTEXT_LENGTH, truncate: bool = True
    ) -> np.ndarray:
        """Batch-tokenize like `clip.tokenize`: [SOT, ids..., EOT, 0...]."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t) + [self.eot]
            if len(ids) > context_length:
                if not truncate:
                    raise ValueError(f"Input too long: {t!r}")
                ids = ids[: context_length - 1] + [self.eot]
            out[i, : len(ids)] = ids
        return out


class ReducedVocab:
    """Usage-ranked reduced subword vocabulary
    (reference `clip_official.py:63-107`).

    Built from an (N, 2) [id, freq] array (the `text_clip_vocab_usage_*.npy`
    assets or a freshly computed table, see `scripts/compute_vocab_usage.py`)."""

    def __init__(self, usage: np.ndarray, sot_original: int = 49406,
                 eot_original: int = 49407):
        usage = np.asarray(usage)
        self.selected_ids = usage[:, 0].astype(np.int64)
        freq = usage[:, 1].astype(np.float64)
        self.freq_dist = freq / freq.sum()
        self.original2reduced = {
            int(o): i for i, o in enumerate(self.selected_ids)
        }
        self.reduced2original = {
            i: int(o) for i, o in enumerate(self.selected_ids)
        }
        self.sot_reduced = self.original2reduced[sot_original]
        self.eot_reduced = self.original2reduced[eot_original]

    @classmethod
    def from_npy(cls, path: str, **kw) -> "ReducedVocab":
        return cls(np.load(path), **kw)

    def __len__(self) -> int:
        return len(self.selected_ids)

    def to_reduced(self, ids: np.ndarray) -> np.ndarray:
        """Map original CLIP ids -> reduced ids (vectorized lookup table)."""
        table = np.full(49408, -1, dtype=np.int64)
        table[self.selected_ids] = np.arange(len(self.selected_ids))
        out = table[np.asarray(ids)]
        if (out < 0).any():
            raise KeyError("id not present in the reduced vocabulary")
        return out

    def to_original(self, ids: np.ndarray) -> np.ndarray:
        return self.selected_ids[np.asarray(ids)]


class ClipTextProcessor:
    """Host-side text helpers matching the reference ClipModel surface:
    `prep_text` (`clip_official.py:168-182`: tokenize + map to reduced ids)
    and `deTokenize` (`:184-200`: reduced->original ids -> text, special
    tokens stripped)."""

    def __init__(self, tokenizer: SimpleTokenizer, vocab: "ReducedVocab" = None):
        self.tokenizer = tokenizer
        self.vocab = vocab

    def prep_text(self, sents, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        ids = self.tokenizer.tokenize(sents, context_length)
        if self.vocab is not None:
            ids = self.vocab.to_reduced(ids)
        return ids

    def detokenize(self, ids) -> list:
        ids = np.asarray(ids)
        if ids.ndim == 1:
            ids = ids[None, :]
        out = []
        for row in ids:
            if self.vocab is not None:
                row = self.vocab.to_original(row)
            text = self.tokenizer.decode(row)
            out.append(
                text.replace("<|startoftext|>", "")
                .replace("<|endoftext|>", "")
                .strip()
            )
        return out

    # reference-compatible alias
    deTokenize = detokenize
