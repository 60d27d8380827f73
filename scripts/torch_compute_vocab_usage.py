#!/usr/bin/env python3
"""Regenerate the CLIP-subword usage tables used for vocabulary reduction,
with the PyTorch port's data pipeline (the port of
`scripts/compute_vocab_usage.py`; same arguments, same files).

Reference: ``avssl/data/{flickr,coco}_stat/stat_textCLIP_input.py``: tokenize
every caption of the dataset with the CLIP tokenizer, count each id's uses
over the padded 77-token sequences, and save (N, 2) [id, freq] arrays sorted
by id and by frequency. `text_clip_vocab_usage_byfreq.npy` is what
`clip.reduce_subword_embbedding` points at (`clip_official.py:63-107`).

    python scripts/torch_compute_vocab_usage.py --dataset flickr \
        --dataset_root /data/flickr --bpe_path /path/bpe_simple_vocab_16e6.txt.gz \
        --out assets/flickr_stat

Imports the port's `data` package (numpy only) and nothing of JAX.
"""
import argparse
import os
import sys
from collections import Counter

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=["flickr", "coco"], required=True)
    ap.add_argument("--dataset_root", required=True)
    ap.add_argument("--bpe_path", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--text_file", default="Flickr8k.token.txt")
    args = ap.parse_args()

    from speechclip_plus_tpu_torch.data import CoCoDataset, FlickrDataset, SimpleTokenizer

    tok = SimpleTokenizer(args.bpe_path)
    counts: Counter = Counter()
    splits = ["train", "dev", "test"] if args.dataset == "flickr" else ["train", "val", "test"]
    for split in splits:
        cls = FlickrDataset if args.dataset == "flickr" else CoCoDataset
        kw = {"text_file": args.text_file} if args.dataset == "flickr" else {}
        ds = cls(args.dataset_root, split=split, load_audio=False, load_image=False,
                 modalities=["text"], **kw)
        for s in ds.data:
            ids = tok.tokenize([s.text])[0]  # padded 77, includes SOT/EOT/pad-0
            counts.update(int(i) for i in ids)

    ids = np.array(sorted(counts.keys()), dtype=np.int64)
    by_id = np.stack([ids, np.array([counts[i] for i in ids])], axis=1)
    order = np.argsort(-by_id[:, 1], kind="stable")
    by_freq = by_id[order]

    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "text_clip_vocab_usage_byID.npy"), by_id)
    np.save(os.path.join(args.out, "text_clip_vocab_usage_byfreq.npy"), by_freq)
    with open(os.path.join(args.out, "text_clip_vocab_usage_byID.txt"), "w") as f:
        for i, c in by_id:
            f.write(f"{i}\t{c}\n")
    print(f"vocab usage: {len(by_id)} distinct ids -> {args.out}")


if __name__ == "__main__":
    main()
