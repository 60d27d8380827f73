#!/usr/bin/env python3
"""Released-checkpoint harness of the PyTorch port (the port of
`scripts/eval_released_checkpoints.py`).

Each released SpeechCLIP+ Lightning checkpoint (fetched with
`scripts/download_ckpts.sh`; the file name carries the expected
`val_recall_mean_10`, reference `download_ckpts.sh:1-24`) goes through the
port's task CLI, `python -m speechclip_plus_tpu_torch.run_task
TrainKWClip_GeneralTransformer --ckpt <file> --eval` (the Lightning importer,
`checkpoint/lightning_import.py`, then the retrieval evaluation on the
matching split), and the run's logged `val_recall_mean_10` is held against
the expected number.

    python scripts/torch_eval_released_checkpoints.py \
        --ckpt_dir ./ckpts --flickr_root /data/flickr --coco_root /data/coco \
        [--tolerance 1.0] [--device cuda]

`--dry` needs no weights and no data: for each released configuration it
resolves the config and the reduced vocabulary, builds the port's model on
the meta device (no memory, no compute) and counts its parameters, and
drives one synthetic eval-split batch through `_build_dataset` ->
`BucketedLoader`. With `--device cuda` (the default) it also builds the
model with seeded random weights on the card, checks the same parameter
count, and runs the port's eval step on that batch there:

    python scripts/torch_eval_released_checkpoints.py --dry --device cpu
    python scripts/torch_eval_released_checkpoints.py --dry [--only base/flickr/hybrid_plus]

`--device cuda` without a card raises: the harness never falls back to the
CPU. Exit code 0 iff every checkpoint (or configuration) passed. Imports the
port and nothing of JAX.
"""
import argparse
import glob
import json
import os
import re
import subprocess
import sys

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)


def expected_from_name(path: str):
    """val_recall_mean_10 encoded in the filename: either the upstream
    `...val_recall_mean_10=42.1100.ckpt` form (download_ckpts.sh:1-24) or
    this repo's `<size>_<ds>_<family>_42.1100.ckpt` form."""
    name = os.path.basename(path)
    m = re.search(r"val_recall_mean_10[=%3D]+(\d+(?:\.\d+)?)", name)
    if m:
        return float(m.group(1))
    m = re.search(r"_(\d+(?:\.\d+)?)\.ckpt$", name)
    return float(m.group(1)) if m else None


# (size, dataset, family, expected val_recall_mean_10) for the 9 released
# checkpoints (reference download_ckpts.sh:1-24) -> this repo's config path
RELEASED = [
    ("base", "flickr", "cascaded_plus", 42.11),
    ("base", "flickr", "hybrid", 80.01),
    ("base", "flickr", "hybrid_plus", 81.03),
    ("large", "flickr", "cascaded_plus", 60.05),
    ("large", "flickr", "hybrid", 90.10),
    ("large", "flickr", "hybrid_plus", 89.35),
    ("large", "coco", "cascaded_plus", 31.2973),
    ("large", "coco", "hybrid", 79.2988),
    ("large", "coco", "hybrid_plus", 83.5408),
]


def config_path_for(size: str, dataset: str, family: str) -> str:
    root = os.path.join(REPO, "config", "speechclip_plus")
    if size == "base":
        return os.path.join(root, "base", f"{family}.yaml")
    return os.path.join(root, "large", dataset, f"{family}.yaml")


def _write_wav(path, n, sr=16000, seed=0):
    import wave

    import numpy as np

    rng = np.random.RandomState(seed)
    data = (rng.randn(n) * 3000).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(data.tobytes())


def _synthetic_root(tmpdir: str, dataset: str) -> str:
    """Minimal on-disk Flickr8k / SpokenCOCO layout (2 images x 2 captions)
    so the dry run drives the real eval-split pipeline: dataset -> bucketed
    loader -> eval step, not just the model build."""
    import json as _json

    import numpy as np
    from PIL import Image

    root = os.path.join(tmpdir, dataset)
    if os.path.isdir(root):
        return root
    names = ["imgA", "imgB"]
    if dataset == "flickr":
        os.makedirs(os.path.join(root, "flickr_audio", "wavs"))
        os.makedirs(os.path.join(root, "Images"))
        with open(os.path.join(root, "Flickr8k_idPairs.json"), "w") as f:
            _json.dump({"filename2Id": {n: i for i, n in enumerate(names)},
                        "id2Filename": {str(i): n for i, n in enumerate(names)}}, f)
        caps = []
        for i, n in enumerate(names):
            Image.fromarray((np.random.RandomState(i).rand(40, 40, 3) * 255).astype(np.uint8)) \
                .save(os.path.join(root, "Images", f"{n}.jpg"))
            for sub in range(2):
                _write_wav(os.path.join(root, "flickr_audio", "wavs", f"{n}_{sub}.wav"),
                           3200 + 320 * sub, seed=i * 7 + sub)
                caps.append(f"{n}.jpg#{sub}\ta dog runs {i}")
        with open(os.path.join(root, "Flickr8k.token.txt"), "w") as f:
            f.write("\n".join(caps))
        for split in ("train", "dev", "test"):
            with open(os.path.join(root, f"Flickr_8k.{split}Images.txt"), "w") as f:
                f.write("\n".join(f"{n}.jpg" for n in names) + "\n")
    else:  # SpokenCOCO
        os.makedirs(os.path.join(root, "SpokenCOCO", "wavs"))
        os.makedirs(os.path.join(root, "mscoco_img"))
        data = []
        for i, n in enumerate(names):
            img = f"COCO_val2014_{i:012d}.jpg"
            Image.fromarray((np.random.RandomState(i).rand(40, 40, 3) * 255).astype(np.uint8)) \
                .save(os.path.join(root, "mscoco_img", img))
            caps = []
            for sub in range(2):
                wav = f"wavs/{n}_{sub}.wav"
                _write_wav(os.path.join(root, "SpokenCOCO", wav), 3200 + 320 * sub,
                           seed=i * 7 + sub)
                caps.append({"wav": wav, "text": f"a dog runs {i}"})
            # reassign_id: used by the karpathy-split files
            # (split_prefix=SpokenCOCO_ksplit, data/datasets.py)
            data.append({"image": img, "captions": caps, "reassign_id": i})
        for prefix in ("SpokenCOCO", "SpokenCOCO_ksplit"):
            for split in ("train", "val", "test"):
                with open(os.path.join(root, "SpokenCOCO", f"{prefix}_{split}.json"), "w") as f:
                    _json.dump({"data": data}, f)
    return root


def require_device(device: str) -> None:
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: this machine has no CUDA device (pass "
                           "--device cpu for the CPU dry run)")


def meta_model(cfg):
    """(model on the meta device, its KWClipConfig) for a loaded config with
    the reduced vocabulary resolved as `build_model_from_config` does, but
    with no storage and no init: the parameter count costs nothing."""
    import torch

    from speechclip_plus_tpu_torch.models import KWClip, KWClipConfig
    from speechclip_plus_tpu_torch.tasks.builder import resolve_reduced_vocab

    vocab = resolve_reduced_vocab(cfg)
    kw = {} if vocab is None else dict(vocab_size=len(vocab), sot_id=int(vocab.sot_reduced),
                                       eot_id=int(vocab.eot_reduced))
    mc = KWClipConfig.from_config(cfg, **kw)
    with torch.device("meta"):
        model = KWClip(mc)
    return model, mc


def parameter_count(model) -> int:
    return sum(p.numel() for p in model.parameters())


def dry_one(td: str, size: str, dataset: str, family: str, device: str) -> str:
    """One released configuration's dry run; returns its report line."""
    import numpy as np
    import torch

    from speechclip_plus_tpu_torch.config import load_config
    from speechclip_plus_tpu_torch.data import BucketedLoader
    from speechclip_plus_tpu_torch.tasks.base_task import _build_dataset

    cfg = load_config(config_path_for(size, dataset, family))
    model, mc = meta_model(cfg)
    assert all(p.is_meta for p in model.parameters())
    n_params = parameter_count(model)
    assert n_params > 0

    # the eval split through the real pipeline
    cfg.data.dataset.dataset_root = _synthetic_root(td, dataset)
    split = "dev" if dataset == "flickr" else "val"
    ds = _build_dataset(cfg, split, image_size=mc.clip.image_resolution)
    loader = BucketedLoader(ds, batch_size=2, shuffle=False, drop_last=False)
    try:
        batch = next(iter(loader))
    finally:
        loader.close()
    res = mc.clip.image_resolution
    assert batch["image"].shape[1:] == (res, res, 3), batch["image"].shape
    assert batch["wav"].shape[0] == 2 and batch["wav"].shape[1] >= int(batch["wav_len"].max())
    line = (f"{n_params / 1e6:.1f}M params, branch={mc.branch_type or 'parallel-only'}, "
            f"eval pipeline wav{tuple(batch['wav'].shape)} image{tuple(batch['image'].shape)}")

    if torch.device(device).type == "cuda":
        from speechclip_plus_tpu_torch.parallel.multihost import make_global_batch
        from speechclip_plus_tpu_torch.parallel.train_step import TrainState, make_eval_step
        from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config

        real, _, _ = build_model_from_config(cfg, device=device, seed=0)
        got = parameter_count(real)
        assert got == n_params, f"{got} parameters on {device}, {n_params} on meta"
        metrics, out = make_eval_step(real)(TrainState(step=0, optimizer=None),
                                           make_global_batch(batch, None, device))
        assert out["audio_feat"].shape == out["image_feat"].shape == (2, mc.clip.embed_dim), (
            out["audio_feat"].shape, out["image_feat"].shape)
        assert "val_loss" in metrics and all(np.isfinite(v) for v in metrics.values()), metrics
        assert np.isfinite(out["audio_feat"]).all() and np.isfinite(out["image_feat"]).all()
        line += (f" -> eval step on {torch.cuda.get_device_name(0)}: feat"
                 f"{tuple(out['audio_feat'].shape)}, val_loss {metrics['val_loss']:.4f}")
        del real
        torch.cuda.empty_cache()
    return line


def dry_run(device: str, only=None) -> int:
    """Every released configuration (or those named `size/dataset/family` in
    `only`) through `dry_one`; returns the number that failed."""
    import tempfile

    require_device(device)
    failures = 0
    with tempfile.TemporaryDirectory() as td:
        for size, dataset, family, expected in RELEASED:
            name = f"{size}/{dataset}/{family}"
            if only and name not in only:
                continue
            try:
                line = dry_one(td, size, dataset, family, device)
                print(f"OK   {name}: expected recall_mean_10={expected}, {line}", flush=True)
            except Exception as e:  # noqa: BLE001 - report and continue
                failures += 1
                print(f"FAIL {name}: {type(e).__name__}: {e}", flush=True)
    return failures


def evaluate(ckpt: str, root: str, save: str, device: str, devices: int):
    """`run_task --ckpt <ckpt> --eval` in a process of its own; returns the
    last `val_recall_mean_10` it logged (None if none)."""
    cmd = [sys.executable, "-m", "speechclip_plus_tpu_torch.run_task",
           "TrainKWClip_GeneralTransformer", "--ckpt", ckpt, "--eval", "--dataset_root", root,
           "--save_path", save, "--device", device, "--devices", str(devices)]
    subprocess.run(cmd, cwd=REPO, check=True)
    with open(os.path.join(save, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return next((r["val_recall_mean_10"] for r in reversed(rows)
                 if "val_recall_mean_10" in r), None)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--flickr_root", default=None)
    ap.add_argument("--coco_root", default=None)
    ap.add_argument("--tolerance", type=float, default=1.0,
                    help="max |got - expected| recall points")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu; never a fallback")
    ap.add_argument("--devices", type=int, default=-1)
    ap.add_argument("--dry", action="store_true",
                    help="no weights or data: build every released configuration on the meta "
                         "device and drive a synthetic eval batch (with --device cuda, through "
                         "the eval step on the card)")
    ap.add_argument("--only", action="append", default=None,
                    help="with --dry: a size/dataset/family to run (repeatable)")
    args = ap.parse_args()

    if args.dry:
        sys.exit(1 if dry_run(args.device, args.only) else 0)
    if not args.ckpt_dir:
        ap.error("--ckpt_dir required unless --dry")
    require_device(args.device)

    failures, results = [], []
    for ckpt in sorted(glob.glob(os.path.join(args.ckpt_dir, "*.ckpt"))):
        name = os.path.basename(ckpt)
        expected = expected_from_name(ckpt)
        is_coco = "coco" in name.lower()
        root = args.coco_root if is_coco else args.flickr_root
        if root is None:
            print(f"SKIP {name}: no dataset root for {'coco' if is_coco else 'flickr'}")
            continue
        got = evaluate(os.path.abspath(ckpt), os.path.abspath(root),
                       os.path.abspath(os.path.join(args.ckpt_dir, "eval_" + name)),
                       args.device, args.devices)
        ok = expected is None or (got is not None and abs(got - expected) <= args.tolerance)
        results.append((name, expected, got, ok))
        if not ok:
            failures.append(name)
        print(f"{'OK  ' if ok else 'FAIL'} {name}: expected={expected} got={got}")

    print("\n== summary ==")
    for name, exp, got, ok in results:
        print(f"  {'OK  ' if ok else 'FAIL'} {name}  expected={exp}  got={got}")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
