"""The port's two tools against the JAX package's, on the CPU.

`scripts/torch_compute_vocab_usage.py` writes the same vocabulary-usage
tables as `scripts/compute_vocab_usage.py`, byte for byte, on a small
Flickr-shaped tree and a SpokenCOCO-shaped one with the BPE merges of
`config/dev/merges.txt`; `scripts/torch_eval_released_checkpoints.py` keeps
the JAX harness's `expected_from_name`, `RELEASED` and `config_path_for`,
its dry run counts the parameters JAX's `jax.eval_shape` counts for base
hybrid+, and its `--dry --device cpu` passes for every released
configuration. Both tools run in a process where importing `jax`, `flax` or
the JAX package raises.
"""
import filecmp
import importlib.util
import os
import subprocess
import sys

import numpy as np

from test_torch_data import MERGES, write_flickr_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
TABLES = ("text_clip_vocab_usage_byID.npy", "text_clip_vocab_usage_byfreq.npy",
          "text_clip_vocab_usage_byID.txt")
# runs a script as __main__ with the JAX stack unimportable
NO_JAX = (
    "import runpy, sys\n"
    "class NoJax:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'speechclip_plus_tpu'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, NoJax())\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n")


def _module(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(script, *args, no_jax=False, timeout=120):
    cmd = [sys.executable] + (["-c", NO_JAX] if no_jax else []) + [
        os.path.join(SCRIPTS, script), *args]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=timeout,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_vocab_tables_byte_equal_to_jax(tmp_path):
    flickr = tmp_path / "flickr"
    write_flickr_tree(flickr, n_train=3, n_dev=2, n_test=2, caps=3)
    coco = _module("torch_eval_released_checkpoints")._synthetic_root(str(tmp_path), "coco")
    for dataset, root in (("flickr", str(flickr)), ("coco", coco)):
        outs = {}
        for who, script, no_jax in (("jax", "compute_vocab_usage.py", False),
                                    ("port", "torch_compute_vocab_usage.py", True)):
            outs[who] = str(tmp_path / f"{dataset}_{who}")
            said = _run(script, "--dataset", dataset, "--dataset_root", root, "--bpe_path",
                        MERGES, "--out", outs[who], no_jax=no_jax)
            assert "distinct ids" in said
        for name in TABLES:
            assert filecmp.cmp(os.path.join(outs["jax"], name), os.path.join(outs["port"], name),
                               shallow=False), (dataset, name)
        by_freq = np.load(os.path.join(outs["port"], TABLES[1]))
        assert by_freq.shape[1] == 2 and by_freq.dtype == np.int64 and len(by_freq) > 5
        assert (np.diff(by_freq[:, 1]) <= 0).all()


def test_expected_from_name_and_released_set_match_jax():
    jax_tool = _module("eval_released_checkpoints")
    port_tool = _module("torch_eval_released_checkpoints")
    names = ["epoch=12-step=1234-val_recall_mean_10=42.1100.ckpt",
             "epoch%3D1-val_recall_mean_10%3D81.03.ckpt",
             "/ckpts/large_coco_hybrid_plus_83.5408.ckpt", "base_flickr_hybrid.ckpt"]
    for name in names:
        assert port_tool.expected_from_name(name) == jax_tool.expected_from_name(name), name
    assert port_tool.expected_from_name(names[0]) == 42.11
    assert port_tool.expected_from_name(names[3]) is None
    assert port_tool.RELEASED == jax_tool.RELEASED
    for size, dataset, family, _ in port_tool.RELEASED:
        port = port_tool.config_path_for(size, dataset, family)
        assert os.path.isfile(port)
        assert os.path.samefile(port, jax_tool.config_path_for(size, dataset, family))


def test_dry_run_parameter_count_matches_jax_eval_shape():
    import jax
    import jax.numpy as jnp

    from speechclip_plus_tpu.config import load_config as jax_load_config
    from speechclip_plus_tpu.models import KWClip, KWClipConfig
    from speechclip_plus_tpu.tasks.builder import resolve_reduced_vocab

    from speechclip_plus_tpu_torch.config import load_config

    port_tool = _module("torch_eval_released_checkpoints")
    path = port_tool.config_path_for("base", "flickr", "hybrid_plus")
    model, mc = port_tool.meta_model(load_config(path))
    got = port_tool.parameter_count(model)

    cfg = jax_load_config(path)
    vocab = resolve_reduced_vocab(cfg)
    jmc = KWClipConfig.from_config(cfg, vocab_size=len(vocab), sot_id=int(vocab.sot_reduced),
                                   eot_id=int(vocab.eot_reduced))
    assert jmc.clip.vocab_size == mc.clip.vocab_size
    batch = {"wav": jnp.zeros((2, 3840), jnp.float32), "wav_len": jnp.array([3840, 3520]),
             "image": jnp.zeros((2, 224, 224, 3), jnp.float32), "id": jnp.arange(2)}
    shapes = jax.eval_shape(lambda r, b: KWClip(jmc).init(r, b, training=False),
                            jax.random.PRNGKey(0), batch)
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert got == want


def test_tools_run_without_jax():
    """`--dry --device cpu` for all nine released configurations in a process
    that cannot import JAX (the vocabulary tool runs so in the test above)."""
    said = _run("torch_eval_released_checkpoints.py", "--dry", "--device", "cpu", no_jax=True,
                timeout=300)
    lines = [line for line in said.splitlines() if line.startswith(("OK", "FAIL"))]
    assert len(lines) == 9 and all(line.startswith("OK") for line in lines), said
    assert "229.4M params, branch=HybridBranch_plus" in said


def test_dry_run_on_cuda_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, os.path.join(SCRIPTS, "torch_eval_released_checkpoints.py"),
                          "--dry", "--only", "base/flickr/hybrid_plus"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert "OK" not in out.stdout
