"""Host-side data pipeline: datasets, audio/image transforms, tokenizer,
collate/bucketing, prefetching loader (port of ``speechclip_plus_tpu/data``;
numpy only, no torch device)."""
from .audio import load_wav, random_crop_max_length, waveform_layer_norm  # noqa: F401
from .collate import BucketedLoader, collate_batch, pad_to_bucket  # noqa: F401
from .datasets import CoCoDataset, FlickrDataset, PairSample  # noqa: F401
from .image import clip_image_transform  # noqa: F401
from .tokenizer import ClipTextProcessor, ReducedVocab, SimpleTokenizer  # noqa: F401
