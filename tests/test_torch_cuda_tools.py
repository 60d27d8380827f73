"""The released-checkpoint harness's dry run on the card (a `cuda` test; it
skips without a card): `scripts/torch_eval_released_checkpoints.py --dry
--device cuda` on base hybrid+ builds the model with seeded random weights
on the card, holds its parameter count to the meta-device build's, and runs
the port's eval step on one synthetic eval-split batch. Imports torch and the
port only: `python -m pytest --noconftest -m cuda tests/test_torch_cuda_tools.py`.
"""
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.cuda
def test_released_checkpoint_dry_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_eval_released_checkpoints.py"),
         "--dry", "--device", "cuda", "--only", "base/flickr/hybrid_plus"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    line = [s for s in out.stdout.splitlines() if s.startswith("OK")]
    assert len(line) == 1 and "eval step on" in line[0] and "feat(2, 512)" in line[0], out.stdout
    print(line[0])
