"""The PyTorch port's host data pipeline against the JAX package, on the CPU.

One small Flickr-shaped tree (and a SpokenCOCO one), written here with
`wave` and PIL, goes through both packages, and the results must be equal,
bit for bit: dataset items, `load_wav` with resampling, the CLIP image
transform, the BPE tokenizer and text processor on `config/dev/merges.txt`,
the reduced vocabulary's maps, `collate_batch`, `BucketedLoader`'s train and
dev batches over two epochs (with `set_epoch`, in a thread and in worker
processes), and the retrieval recalls on scores with ties.

`write_flickr_tree` is shared with `test_torch_trainer.py` and
`test_torch_task_cli.py`.
"""
import json
import os
import wave

import numpy as np
import pytest
from PIL import Image

import speechclip_plus_tpu.data as jdata
from speechclip_plus_tpu.data.image import clip_image_transform as jax_transform
from speechclip_plus_tpu.ops.retrieval import mutual_retrieval as jax_mutual
from speechclip_plus_tpu.ops.retrieval import recall_at_k as jax_recall

import speechclip_plus_tpu_torch.data as pdata
from speechclip_plus_tpu_torch.data.image import clip_image_transform
from speechclip_plus_tpu_torch.ops.retrieval import mutual_retrieval, recall_at_k

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MERGES = os.path.join(REPO, "config", "dev", "merges.txt")
FLICKR_USAGE = os.path.join(REPO, "assets", "flickr_stat", "text_clip_vocab_usage_byfreq.npy")


def write_wav(path, n, sr=16000, seed=0, channels=1, width=2):
    rng = np.random.RandomState(seed)
    data = rng.randn(n * channels) * 3000
    if width == 2:
        raw = data.astype("<i2").tobytes()
    elif width == 4:
        raw = (data * 65536).astype("<i4").tobytes()
    else:
        raw = (np.clip(data / 256 + 128, 0, 255)).astype(np.uint8).tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(raw)


def write_flickr_tree(root, n_train=4, n_dev=4, n_test=2, caps=2, wav_len=(2400, 3600)):
    """A Flickr8k-shaped tree: `n_*` images per split with `caps` spoken
    captions each, wav lengths drawn in `wav_len`, images of varied size."""
    root = str(root)
    os.makedirs(os.path.join(root, "flickr_audio", "wavs"), exist_ok=True)
    os.makedirs(os.path.join(root, "Images"), exist_ok=True)
    rng = np.random.RandomState(11)
    splits = {"train": n_train, "dev": n_dev, "test": n_test}
    filename2id, lines, i = {}, [], 0
    for split, n in splits.items():
        names = []
        for _ in range(n):
            name = f"img{i}"
            names.append(name + ".jpg")
            filename2id[name] = 100 + 7 * i
            h, w = 40 + 3 * i, 60 - 2 * i
            Image.fromarray((np.random.RandomState(i).rand(h, w, 3) * 255).astype(np.uint8)) \
                .save(os.path.join(root, "Images", name + ".jpg"))
            for sub in range(caps):
                n_samples = int(rng.randint(wav_len[0], wav_len[1] + 1))
                write_wav(os.path.join(root, "flickr_audio", "wavs", f"{name}_{sub}.wav"),
                          n_samples, seed=100 * i + sub)
                lines.append(f"{name}.jpg#{sub}\tthe cat runs at a dog {i} {sub} .")
            i += 1
        with open(os.path.join(root, f"Flickr_8k.{split}Images.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    # an artifact the parser must skip (reference flickr_dataset.py:134-137)
    write_wav(os.path.join(root, "flickr_audio", "wavs", "img0_txt.wav"), 1000)
    with open(os.path.join(root, "Flickr8k.token.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "Flickr8k_idPairs.json"), "w") as f:
        json.dump({"filename2Id": filename2id}, f)
    return root


def assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], str):
            assert a[k] == b[k], k
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def flickr(tmp_path_factory):
    return write_flickr_tree(tmp_path_factory.mktemp("data") / "flickr", n_train=5)


@pytest.fixture(scope="module")
def tokenizers():
    return jdata.SimpleTokenizer(MERGES), pdata.SimpleTokenizer(MERGES)


@pytest.mark.parametrize("split", ["train", "dev", "test"])
@pytest.mark.parametrize("tokenize", [False, True])
def test_flickr_items_equal(flickr, tokenizers, split, tokenize):
    kw = dict(split=split, normalize_waveform=True, image_size=32, tokenize_text=tokenize)
    jds = jdata.FlickrDataset(flickr, tokenizer=tokenizers[0], **kw)
    pds = pdata.FlickrDataset(flickr, tokenizer=tokenizers[1], **kw)
    assert len(jds) == len(pds) > 0
    assert [vars(s) for s in jds.data] == [vars(s) for s in pds.data]
    for i in range(len(pds)):
        assert_items_equal(jds[i], pds[i])


def test_flickr_modalities_and_caption_formats(flickr, tmp_path):
    for modalities in (["image"], ["audio"], ["audio", "text"]):
        jds = jdata.FlickrDataset(flickr, modalities=modalities, image_size=32)
        pds = pdata.FlickrDataset(flickr, modalities=modalities, image_size=32)
        assert [vars(s) for s in jds.data] == [vars(s) for s in pds.data]
        assert_items_equal(jds[0], pds[0])
    # captions.txt, the third caption format
    with open(os.path.join(flickr, "Flickr8k.token.txt")) as f:
        rows = [line.split("\t") for line in f.read().splitlines() if line]
    with open(os.path.join(flickr, "captions.txt"), "w") as f:
        f.write("image,caption\n" + "".join(
            f"{name.split('#')[0]},{cap.upper()}.\n" for name, cap in rows))
    jds = jdata.FlickrDataset(flickr, text_file="captions.txt", load_audio=False,
                              load_image=False)
    pds = pdata.FlickrDataset(flickr, text_file="captions.txt", load_audio=False,
                              load_image=False)
    assert [vars(s) for s in jds.data] == [vars(s) for s in pds.data]


def test_coco_items_equal(tmp_path):
    root = tmp_path / "coco"
    (root / "SpokenCOCO" / "wavs").mkdir(parents=True)
    (root / "mscoco_img").mkdir()
    entries = []
    for i in range(3):
        img = f"COCO_val2014_{40 + i:012d}.jpg"
        Image.fromarray((np.random.RandomState(i).rand(30, 50, 3) * 255).astype(np.uint8)) \
            .save(root / "mscoco_img" / img)
        caps = []
        for j in range(2):
            write_wav(root / "SpokenCOCO" / "wavs" / f"{i}_{j}.wav", 3000 + 100 * j, seed=i + j)
            caps.append({"wav": f"wavs/{i}_{j}.wav", "text": f"A Cat {i} {j}"})
        entries.append({"image": img, "captions": caps, "reassign_id": str(7 * i)})
    for prefix in ("SpokenCOCO", "SpokenCOCO_k"):
        (root / "SpokenCOCO" / f"{prefix}_val.json").write_text(json.dumps({"data": entries}))
        jds = jdata.CoCoDataset(str(root), split="val", split_prefix=prefix, image_size=32)
        pds = pdata.CoCoDataset(str(root), split="val", split_prefix=prefix, image_size=32)
        assert len(pds) == 6
        assert [vars(s) for s in jds.data] == [vars(s) for s in pds.data]
        for i in range(len(pds)):
            assert_items_equal(jds[i], pds[i])


@pytest.mark.parametrize("sr,channels,width", [(16000, 1, 2), (8000, 1, 2), (22050, 2, 2),
                                               (44100, 1, 4), (16000, 2, 1)])
def test_load_wav_equal(tmp_path, sr, channels, width):
    path = str(tmp_path / "x.wav")
    write_wav(path, sr // 3, sr=sr, channels=channels, width=width)
    got, want = pdata.load_wav(path), jdata.load_wav(path)
    assert got.dtype == np.float32 and abs(len(got) - 16000 // 3) <= 16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pdata.waveform_layer_norm(got), jdata.waveform_layer_norm(want))
    rng_a, rng_b = np.random.RandomState(3), np.random.RandomState(3)
    for n in (100, 1000, 100000, -1):
        np.testing.assert_array_equal(pdata.random_crop_max_length(got, n, rng=rng_a),
                                      jdata.random_crop_max_length(want, n, rng=rng_b))


@pytest.mark.parametrize("size,shape,mode", [(224, (100, 160), "RGB"), (32, (40, 30), "RGB"),
                                             (32, (33, 90), "L"), (224, (224, 224), "RGBA")])
def test_clip_image_transform_equal(size, shape, mode):
    rng = np.random.RandomState(size + shape[0])
    channels = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
    arr = (rng.rand(*shape, channels) * 255).astype(np.uint8)
    img = Image.fromarray(arr[..., 0] if channels == 1 else arr, mode)
    got = clip_image_transform(img, size)
    assert got.shape == (size, size, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_transform(img, size))


def test_tokenizer_equal(tokenizers):
    jtok, ptok = tokenizers
    assert ptok.encoder == jtok.encoder and ptok.bpe_ranks == jtok.bpe_ranks
    assert (ptok.sot, ptok.eot, ptok.vocab_size) == (jtok.sot, jtok.eot, jtok.vocab_size)
    texts = ["the cat runs at a dog", "A  DOG!! runs, in the field 42 .", "it's &amp; don't",
             "café naïve über", "catcatcat dogs"]
    for t in texts:
        ids = ptok.encode(t)
        assert ids == jtok.encode(t)
        assert ptok.decode(ids) == jtok.decode(ids)
    np.testing.assert_array_equal(ptok.tokenize(texts, context_length=12),
                                  jtok.tokenize(texts, context_length=12))
    with pytest.raises(ValueError):
        ptok.tokenize(texts[1], context_length=4, truncate=False)


def test_reduced_vocab_maps_equal():
    usage = np.array([[0, 100], [5, 50], [49406, 10], [49407, 10], [7, 5]])
    for table, kw in ((usage, {}), (np.load(FLICKR_USAGE), {})):
        rv, jrv = pdata.ReducedVocab(table, **kw), jdata.ReducedVocab(table, **kw)
        assert len(rv) == len(jrv)
        assert (rv.sot_reduced, rv.eot_reduced) == (jrv.sot_reduced, jrv.eot_reduced)
        assert rv.original2reduced == jrv.original2reduced
        assert rv.reduced2original == jrv.reduced2original
        np.testing.assert_array_equal(rv.freq_dist, jrv.freq_dist)
        ids = rv.selected_ids[::7]
        np.testing.assert_array_equal(rv.to_reduced(ids), jrv.to_reduced(ids))
        red = np.arange(len(rv))[::5]
        np.testing.assert_array_equal(rv.to_original(red), jrv.to_original(red))
        np.testing.assert_array_equal(rv.to_original(rv.to_reduced(ids)), ids)
    rv = pdata.ReducedVocab(usage)
    np.testing.assert_array_equal(rv.to_reduced([0, 5, 7]), [0, 1, 4])
    with pytest.raises(KeyError):
        rv.to_reduced([3])


def test_clip_text_processor_equal(tokenizers):
    jtok, ptok = tokenizers
    ids_used = sorted(set(ptok.encode("the cat runs at a dog")) | {0, ptok.sot, ptok.eot})
    usage = np.array([[i, 10] for i in ids_used], dtype=np.int64)
    kw = dict(sot_original=ptok.sot, eot_original=ptok.eot)
    proc = pdata.ClipTextProcessor(ptok, pdata.ReducedVocab(usage, **kw))
    jproc = jdata.ClipTextProcessor(jtok, jdata.ReducedVocab(usage, **kw))
    sents = ["the cat runs", "a dog at the cat"]
    batch = proc.prep_text(sents, context_length=12)
    np.testing.assert_array_equal(batch, jproc.prep_text(sents, context_length=12))
    assert proc.detokenize(batch) == jproc.detokenize(batch)
    assert proc.deTokenize(batch[0]) == jproc.deTokenize(batch[0])
    assert proc.detokenize(batch)[0].startswith("the cat runs")
    plain = pdata.ClipTextProcessor(ptok)
    np.testing.assert_array_equal(plain.prep_text(sents), jdata.ClipTextProcessor(jtok)
                                  .prep_text(sents))


def test_collate_equal(flickr, tokenizers):
    ds = pdata.FlickrDataset(flickr, split="train", image_size=32, tokenize_text=True,
                             tokenizer=tokenizers[1])
    items = [ds[i] for i in range(3)]
    for buckets in ((1920, 3840), pdata.collate.DEFAULT_BUCKETS, (1000,)):
        for pad in (None, 3, 5):
            got = pdata.collate_batch(items, buckets, pad_to_size=pad)
            want = jdata.collate_batch(items, buckets, pad_to_size=pad)
            assert_items_equal(got, want)
    cached = [{"wav": it["wav"], "id": it["id"], "image_feat": np.full(4, i, np.float32)}
              for i, it in enumerate(items)]
    assert_items_equal(pdata.collate_batch(cached, pad_to_size=4),
                       jdata.collate_batch(cached, pad_to_size=4))
    assert pdata.pad_to_bucket(5000, (1920, 3840)) == jdata.pad_to_bucket(5000, (1920, 3840))


LOADERS = {
    "train": dict(batch_size=3, shuffle=True, drop_last=True, max_audio_len=2000, train=True,
                  seed=5, buckets=(1920, 3840)),
    "dev": dict(batch_size=3, shuffle=False, drop_last=False),
}


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("kind", ["train", "dev"])
def test_bucketed_loader_equal(flickr, kind, workers):
    """Two epochs, then epoch 1 again through `set_epoch`: the port's thread
    and worker-process loaders give the JAX thread loader's batches."""
    split = "train" if kind == "train" else "dev"
    jds = jdata.FlickrDataset(flickr, split=split, image_size=32, normalize_waveform=True)
    pds = pdata.FlickrDataset(flickr, split=split, image_size=32, normalize_waveform=True)
    jl = jdata.BucketedLoader(jds, **LOADERS[kind], num_workers=0)
    pl = pdata.BucketedLoader(pds, **LOADERS[kind], num_workers=workers, prefetch=2)
    try:
        assert len(pl) == len(jl) > 1
        epochs = []
        for epoch in range(2):
            want, got = list(jl), list(pl)
            assert len(got) == len(want) == len(pl)
            for a, b in zip(got, want):
                assert_items_equal(a, b)
            epochs.append(got)
        if kind == "train":  # the seeded shuffle differs between epochs
            assert not np.array_equal(epochs[0][0]["id"], epochs[1][0]["id"])
        pl.set_epoch(1)
        for a, b in zip(list(pl), epochs[1]):
            assert_items_equal(a, b)
        if kind == "dev":  # the final batch is padded to the batch size, masked
            last = epochs[0][-1]
            assert last["wav"].shape[0] == 3 and last["valid"].sum() == 2
    finally:
        pl.close()


def test_recall_equal():
    rng = np.random.RandomState(0)
    # quantized scores: many exact ties, which the stable sort orders by index
    scores = np.round(rng.randn(30, 12) * 2) / 2
    qa = rng.randint(0, 12, 30)
    ga = np.arange(12)
    for ks in ((1, 5, 10), (1, 3), (20,)):
        assert recall_at_k(scores, qa, ga, ks) == jax_recall(scores, qa, ga, ks)
    got = mutual_retrieval(scores, scores.T, qa, ga, (1, 5, 10))
    assert got == jax_mutual(scores, scores.T, qa, ga, (1, 5, 10))
    assert set(got[2]) == {"recall@1", "recall@5", "recall@10"}
    tied = np.zeros((4, 4))
    assert recall_at_k(tied, np.arange(4), np.arange(4), (1,)) == {"recall@1": 25.0}
