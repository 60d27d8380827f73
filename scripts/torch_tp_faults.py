"""Path R's limits against planted faults (PyTorch/CUDA port, on the card).

R1 holds a tensor-parallel fit against the one-process fit by three
readings (`chip_smoke.tp_against_one`): step 1's loss and `grad_norm`, and
the worst trainable tensor's Adam first moment after 4 steps. This script
reads them for the sound checkout and for copies of it with one collective
of `parallel/tp.py`'s plan left out, so that each limit can sit between the
sound reading and the faulty ones:

    dx          K3b's shard partial dx not summed over the model group
    clip_bwd    CLIP's MLP without `copy_to_model` (its input gradient not summed)
    clip_fwd    CLIP's `c_proj` partial not summed
    hubert_fwd  HuBERT's `fc2` partial not summed

Each copy goes to a temporary directory (this checkout is not touched) and
runs R1's tp=2 fit (two gloo ranks sharing the card, hybrid+ base, B=128,
crops of `TP_AUDIO`, `TP_TOTAL` steps); one process without a group is the
reference. At most five processes share the card at a time. One line per
fit with the three readings and every tensor's moment norm and relative
difference, then a JSON object of the readings:

    python3 scripts/torch_tp_faults.py [--faults dx clip_bwd ...]

Needs a CUDA card and nvcc (about 4 minutes with the kernels' build).
"""
import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = {  # name: (file, the text of the sound code, the text that plants the fault)
    "dx": ("speechclip_plus_tpu_torch/ops/fused_keyword.py",
           "return all_reduce_model(dx, mg), all_reduce_model(dt.reshape(1), mg)[0]",
           "return dx, all_reduce_model(dt.reshape(1), mg)[0]"),
    "clip_bwd": ("speechclip_plus_tpu_torch/models/clip.py",
                 "h = copy_to_model(self.ln_2(x), self.tp)", "h = self.ln_2(x)"),
    "clip_fwd": ("speechclip_plus_tpu_torch/models/clip.py",
                 "row_parallel_linear(h, proj.weight.to(cd), proj.bias.to(cd), self.tp, cd)",
                 "row_parallel_linear(h, proj.weight.to(cd), proj.bias.to(cd), None, cd)"),
    "hubert_fwd": ("speechclip_plus_tpu_torch/models/hubert.py",
                   "self.fc2.weight.to(cd), self.fc2.bias.to(cd), self.tp, cd)",
                   "self.fc2.weight.to(cd), self.fc2.bias.to(cd), None, cd)"),
}


def planted(name, tmp):
    """A copy of this checkout (its kernel build included) with fault `name`."""
    if name == "sound":
        return ROOT
    path, sound, fault = FAULTS[name]
    dst = os.path.join(tmp, f"checkout_{name}")
    shutil.copytree(ROOT, dst, ignore=shutil.ignore_patterns(".git", "__pycache__"))
    with open(os.path.join(dst, path)) as f:
        src = f.read()
    if src.count(sound) != 1:
        raise SystemExit(f"{name}: {path} holds the sound code {src.count(sound)} times")
    with open(os.path.join(dst, path), "w") as f:
        f.write(src.replace(sound, fault))
    return dst


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--faults", nargs="+", choices=sorted(FAULTS), default=list(FAULTS))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_tp_faults: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from speechclip_plus_tpu_torch.config import load_config
    from speechclip_plus_tpu_torch.optim.optimizer import trainable_parameters
    from speechclip_plus_tpu_torch.tasks.builder import build_model_from_config
    from speechclip_plus_tpu_torch.utils import cuda_build

    cuda_build.kernels()  # built once, here, and copied with the checkout
    names = [n for n, _ in trainable_parameters(build_model_from_config(
        load_config(cs.FIT_CONFIG), device="meta", seed=0)[0])]
    tmp = tempfile.mkdtemp(prefix="tp_faults_")
    try:
        tree = cs.synthetic_tree("faults", cs.TP_TREE)

        def cfg(tp):  # R1's fit
            return {"trainer.max_steps": cs.TP_TOTAL, "trainer.log_every_n_steps": 1,
                    "trainer.check_val_every_n_epoch": 1000, "trainer.tensor_parallel": tp,
                    "audio_encoder.max_audio_len": cs.TP_AUDIO}

        def start(name):
            spec = {"label": f"R fault {name}", "tree": tree, "world": 2, "group": "gloo",
                    "runs": [cs.fit_run_spec(tmp, name, cfg(2))]}
            own = cs.__file__  # the leg runs the copy's chip_smoke.py and package
            cs.__file__ = os.path.join(planted(name, tmp), "chip_smoke.py")
            try:
                return cs.start_leg(spec)
            finally:
                cs.__file__ = own

        fits = ["sound", *args.faults]
        waves = [fits[i: i + 2] for i in range(0, len(fits), 2)]  # two pairs of ranks
        one = cs.start_leg({"label": "R fault one process", "tree": tree, "world": 1,
                            "group": None, "runs": [cs.fit_run_spec(tmp, "alone", cfg(1))]})
        legs = {name: start(name) for name in waves[0]}
        cs.finish_leg(one)
        out = {}
        for wave in waves:
            legs.update({name: start(name) for name in wave if name not in legs})
            for name in wave:
                cs.finish_leg(legs[name])
                rels, worst, held, table = cs.tp_against_one(
                    torch, os.path.join(tmp, name), os.path.join(tmp, "alone"), names=names)
                out[name] = rels
                print(f"[faults] {name} against one process: " + ", ".join(
                    f"{k} {v:.3e}" for k, v in rels.items()) + f"; the moment's worst of "
                    f"{held}: {worst}; every tensor (|m_one|, relative): " + "; ".join(
                        f"{n} {m:.3e} {d:.3e}" for n, m, d in table), flush=True)
        print(cs.card_line())
        print(json.dumps(out))
    finally:
        cs.remove_trees()
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
