"""Flickr8k + SpokenCOCO paired speech-image datasets (host side).

Port of ``speechclip_plus_tpu/data/datasets.py``: items stay numpy and the
dataset touches no torch device.

Reference semantics:
  - `FlickrDataset` (`avssl/data/flickr_dataset.py:15-158`): split lists from
    `Flickr_8k.<split>Images.txt`, wavs under `flickr_audio/wavs[_with_no_
    silence]` named `<imageName>_<subID>.wav`, three caption-file formats,
    stable image ids from `Flickr8k_idPairs.json`.
  - `CoCoDataset` (`avssl/data/coco_dataset.py:15-92`): entries from
    `SpokenCOCO/<prefix>_<split>.json`, id from the image filename (or
    `reassign_id` for k-splits), wav/image paths joined to the dataset root.
  - `BaseDataset.__getitem__` (`avssl/data/base_dataset.py:70-147`): load wav
    (16 kHz, optional per-utterance layer norm), CLIP image transform,
    `clip.tokenize` of the caption.

The sample iterator returns numpy arrays; batching/padding/prefetch live in
`data/collate.py` (length-bucketed shapes, as in the JAX package).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np

from .audio import load_wav, wav_length, waveform_layer_norm
from .image import clip_image_transform

logger = logging.getLogger(__name__)

__all__ = ["PairSample", "BaseDataset", "FlickrDataset", "CoCoDataset"]


@dataclasses.dataclass
class PairSample:
    id: int
    wav_path: Optional[str] = None
    image_path: Optional[str] = None
    text: Optional[str] = None


class BaseDataset:
    """Map-style dataset of (wav, image, caption, id) items as numpy."""

    def __init__(
        self,
        dataset_root: str,
        split: str = "train",
        target_sr: int = 16000,
        load_audio: bool = True,
        load_image: bool = True,
        tokenize_text: bool = False,
        normalize_waveform: bool = False,
        image_size: int = 224,
        tokenizer=None,
        image_transform: Optional[Callable] = None,
    ):
        self.dataset_root = dataset_root
        self.split = split
        self.target_sr = target_sr
        self.load_audio = load_audio
        self.load_image = load_image
        self.tokenize_text = tokenize_text
        self.normalize_waveform = normalize_waveform
        self.image_size = image_size
        self.tokenizer = tokenizer
        self.image_transform = image_transform
        self.data: List[PairSample] = []

    def __len__(self) -> int:
        return len(self.data)

    def wav_length(self, index: int) -> int:
        """The length `__getitem__`'s wav has, from the file's header alone
        (a data-parallel rank's loader needs the other ranks' lengths)."""
        path = self.data[index].wav_path
        return 0 if path is None else wav_length(path, self.target_sr)

    def __getitem__(self, index: int) -> Dict:
        s = self.data[index]
        out: Dict = {"id": np.int32(s.id)}
        if s.wav_path is not None:
            if self.load_audio:
                wav = load_wav(s.wav_path, self.target_sr)
                if self.normalize_waveform:
                    wav = waveform_layer_norm(wav)
                out["wav"] = wav
            else:
                out["wav"] = s.wav_path
        if s.image_path is not None:
            if self.load_image:
                from PIL import Image

                with Image.open(s.image_path) as img:
                    arr = (
                        self.image_transform(img)
                        if self.image_transform is not None
                        else clip_image_transform(img, self.image_size)
                    )
                out["image"] = arr
            else:
                out["image"] = s.image_path
        if s.text is not None:
            if self.tokenize_text and self.tokenizer is not None:
                out["text"] = self.tokenizer.tokenize([s.text])[0]
            else:
                out["text"] = s.text
        return out


def _strip_trailing_period(caption: str) -> str:
    caption = caption.strip()
    if caption.endswith("."):
        caption = caption[:-1].strip()
    return caption


class FlickrDataset(BaseDataset):
    CAPTION_FILES = ("captions.txt", "Flickr8k.lemma.token.txt", "Flickr8k.token.txt")

    def __init__(
        self,
        dataset_root: str,
        text_file: str = "Flickr8k.token.txt",
        modalities: List[str] = ("audio", "image", "text"),
        split: str = "train",
        wav_rm_silence: bool = False,
        **kwargs,
    ):
        super().__init__(dataset_root=dataset_root, split=split, **kwargs)
        assert text_file in self.CAPTION_FILES, text_file
        self.modalities = list(modalities)

        wav_dir = "wavs_with_no_silence" if wav_rm_silence else "wavs"
        wav_base = os.path.join(dataset_root, "flickr_audio", wav_dir)
        name_to_wavs = defaultdict(dict)
        for fname in sorted(os.listdir(wav_base)):
            if not fname.endswith(".wav"):
                continue
            stem = fname[: -len(".wav")]
            name, _, sub = stem.rpartition("_")
            if not sub.isdigit():
                continue  # e.g. "_txt" artifacts (reference flickr_dataset.py:134-137)
            name_to_wavs[name][int(sub)] = os.path.join(wav_base, fname)

        captions = self._parse_captions(os.path.join(dataset_root, text_file), text_file)

        with open(os.path.join(dataset_root, "Flickr8k_idPairs.json")) as f:
            filename2id = json.load(f)["filename2Id"]

        split_list = os.path.join(dataset_root, f"Flickr_8k.{split}Images.txt")
        with open(split_list) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                name = line.rsplit(".", 1)[0]
                image_path = os.path.join(dataset_root, "Images", line)
                if name not in name_to_wavs:
                    continue
                if "audio" in self.modalities or "text" in self.modalities:
                    for sub, wav_path in sorted(name_to_wavs[name].items()):
                        self.data.append(
                            PairSample(
                                id=int(filename2id[name]),
                                wav_path=wav_path if "audio" in self.modalities else None,
                                image_path=image_path if "image" in self.modalities else None,
                                text=captions[name][sub] if "text" in self.modalities else None,
                            )
                        )
                else:
                    self.data.append(
                        PairSample(id=int(filename2id[name]), image_path=image_path)
                    )
        logger.info("Flickr8k (%s): %d samples", split, len(self.data))

    @staticmethod
    def _parse_captions(path: str, text_file: str) -> Dict[str, Dict[int, str]]:
        caps: Dict[str, Dict[int, str]] = defaultdict(dict)
        with open(path, "r") as f:
            if text_file == "captions.txt":
                counters: Dict[str, int] = defaultdict(int)
                for line in f:
                    if line.strip() == "image,caption" or not line.strip():
                        continue
                    name, cap = line.split(".jpg,", 1)
                    idx = counters[name]
                    counters[name] += 1
                    caps[name][idx] = _strip_trailing_period(cap.lower())
            else:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    m = re.match(r"^(.*?)\.jpg#(\d)\s+(.*)$", line)
                    if m is None:
                        continue
                    caps[m.group(1)][int(m.group(2))] = _strip_trailing_period(
                        m.group(3)
                    )
        return caps


class CoCoDataset(BaseDataset):
    def __init__(
        self,
        dataset_root: str,
        modalities: List[str] = ("audio", "image", "text"),
        split: str = "train",
        split_prefix: str = "SpokenCOCO",
        **kwargs,
    ):
        super().__init__(dataset_root=dataset_root, split=split, **kwargs)
        assert split in ("train", "val", "test")
        self.modalities = list(modalities)
        json_path = os.path.join(
            dataset_root, "SpokenCOCO", f"{split_prefix}_{split}.json"
        )
        with open(json_path) as f:
            raw = json.load(f)["data"]
        for entry in raw:
            if split_prefix != "SpokenCOCO":
                data_id = int(entry["reassign_id"])
            else:
                data_id = int(entry["image"].split("_")[-1].replace(".jpg", ""))
            image_path = os.path.join(dataset_root, "mscoco_img", entry["image"])
            if "audio" in self.modalities or "text" in self.modalities:
                for cap in entry["captions"]:
                    self.data.append(
                        PairSample(
                            id=data_id,
                            wav_path=(
                                os.path.join(dataset_root, "SpokenCOCO", cap["wav"])
                                if "audio" in self.modalities else None
                            ),
                            image_path=image_path if "image" in self.modalities else None,
                            text=cap["text"].lower() if "text" in self.modalities else None,
                        )
                    )
            else:
                self.data.append(PairSample(id=data_id, image_path=image_path))
        logger.info("SpokenCOCO (%s): %d samples", split, len(self.data))
