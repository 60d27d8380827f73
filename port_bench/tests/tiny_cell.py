"""A tiny cell on the CPU: `config/dev/tiny.yaml` with its architecture, the
two traffic mixes cut to a few rows, written into a scratch root that the
harness resolves by name as it resolves the real cells."""
from __future__ import annotations

import json
import os
import shutil

import yaml

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY_ARCH = {
    "audio": {"name": "tiny", "conv_layers": [[16, 3, 2], [16, 3, 2]],
              "extractor_mode": "group_norm", "d_model": 32, "n_layers": 2, "n_heads": 4,
              "ffn_dim": 64, "layer_norm_first": False, "conv_pos": 16, "conv_pos_groups": 2,
              "dropout": 0.1, "attention_dropout": 0.1, "downsample_rate": 4,
              "normalize_contrib": False},
    "branch": {"type": "HybridBranch_plus", "heads": 4, "dropout": 0.1, "layer_norm_eps": 1e-5},
    "cif": {"conv_width": 3, "threshold": 1.0, "max_slots": 14, "scaling_step": 10,
            "tail_threshold": 0.5, "quantity_loss_weight": 0.25},
    "vq": {"temperature": 0.1, "masked_ids": [0, 2, 3]},
    "clip": {"name": "tiny", "vocab_size": 64, "sot_id": 62, "eot_id": 63, "context_length": 16,
             "text_layers": 2, "text_heads": 4, "text_width": 32, "embed_dim": 32,
             "vision_layers": 2, "vision_heads": 2, "vision_width": 24, "patch_size": 16,
             "image_resolution": 32},
    "has_parallel": True, "has_cascaded": True, "cascaded_weight": 1.0, "parallel_weight": 1.0,
    "retrieval_feat": "parallel",
}

# the same cell at widths the card's kernels take (heads of 64, K3 widths a
# multiple of 16; the tiny ViT's heads of 12 take the plain attention)
CARD_ARCH = {**TINY_ARCH,
             "audio": {**TINY_ARCH["audio"], "d_model": 256},
             "clip": {**TINY_ARCH["clip"], "text_width": 64, "embed_dim": 64}}
CARD_YAML = {"audio_encoder.tiny_width": 256, "clip.tiny_width": 64,
             "clip.fused_attention_block": False,
             "model_settings.parallel_branch.transformer_args.d_model": 256,
             "model_settings.cascaded_branch.transformer_args.d_model": 256,
             "model_settings.cascaded_branch.downsampling.cif.cif_output_dim": 256,
             "model_settings.cascaded_branch.downsampling.cif.encoder_embed_dim": 256}

MIXES = {
    "train_tiny": {"loop": "train", "batch": "config", "min_s": 0.05, "max_s": 0.2,
                   "sample_rate": 16000, "crop": "config", "distinct": 4, "images": 16,
                   "check": 3, "warmup": 1, "trace_skip": 1, "trace_steps": 1},
    "search_tiny": {"loop": "search", "batch": 4, "min_s": 0.05, "max_s": 0.2,
                    "sample_rate": 16000, "distinct": 3, "images": 16, "k": 5, "depth": 2,
                    "check": 2, "trace_skip": 1, "trace_steps": 1},
}

LOOSE = {"tiny.train": {"loss_gap": 1e-4, "grad_gap": 1e-3, "step_gap": 1e-3, "kw_gap": 1e-4},
         "tiny.search": {"score_gap": 1e-4, "rank_gap": 1e-4},
         "tiny_cas.search": {"score_gap": 1e-4, "rank_gap": 1e-4, "kw_gap": 1e-4}}


# on the card the attention kernels multiply fp32 operands in TF32
CARD_LIMITS = {"tiny.train": {"loss_gap": 1e-2, "grad_gap": 1e-2, "step_gap": 5e-2,
                              "kw_gap": 1e-2},
               "tiny.search": {"score_gap": 1e-2, "rank_gap": 1e-2},
               "tiny_cas.search": {"score_gap": 1e-2, "rank_gap": 1e-2, "kw_gap": 1e-2}}


def write_root(root: str, arch: dict = None, yaml_overrides: dict = None,
               limits: dict = None) -> str:
    """A root holding BENCHMARK.json, the tiny configuration, its mixes and
    limits, and the benchmark's code (the real metric readers)."""
    with open(os.path.join(REPO, "config", "dev", "tiny.yaml")) as f:
        y = yaml.safe_load(f)
    y["data"]["batch_size"] = 6
    y["audio_encoder"]["max_audio_len"] = 3200
    for k, v in (yaml_overrides or {}).items():
        node = y
        *path, last = k.split(".")
        for p in path:
            node = node[p]
        node[last] = v
    pb = os.path.join(root, "port_bench")
    shutil.copytree(os.path.join(REPO, "port_bench"), pb,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(pb, sub), exist_ok=True)
    arch = arch or TINY_ARCH
    with open(os.path.join(pb, "configs", "tiny.json"), "w") as f:
        json.dump({"source": "config/dev/tiny.yaml", "yaml": y, "arch": arch}, f)
    # the same model serving its cascaded feature (keywords on the path)
    y_cas = json.loads(json.dumps(y))
    y_cas["retrieval"]["audio_feat_src"] = "cascaded"
    with open(os.path.join(pb, "configs", "tiny_cas.json"), "w") as f:
        json.dump({"source": "config/dev/tiny.yaml", "yaml": y_cas,
                   "arch": {**arch, "retrieval_feat": "cascaded"}}, f)
    for name, mix in MIXES.items():
        with open(os.path.join(pb, "traffic", name + ".json"), "w") as f:
            json.dump(mix, f)
    for name, lim in {**LOOSE, **(limits or {})}.items():
        with open(os.path.join(pb, "limits", name + ".json"), "w") as f:
            json.dump(lim, f)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [{"name": c, "source": "config/dev/tiny.yaml",
                         "file": f"port_bench/configs/{c}.json", "reduced": [], "why": "test"}
                        for c in ("tiny", "tiny_cas")]
    bench["workloads"] = [
        {"name": "tiny.train", "config": "tiny", "traffic": "train_tiny", "chips": 1, "why": "t"},
        {"name": "tiny.search", "config": "tiny", "traffic": "search_tiny", "chips": 1,
         "why": "t"},
        {"name": "tiny_cas.search", "config": "tiny_cas", "traffic": "search_tiny", "chips": 1,
         "why": "t"}]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
