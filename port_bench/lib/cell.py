"""One run of one cell: the program's model, its seeded weights and inputs.

The program under test is `speechclip_plus_tpu_torch`, imported here and
nowhere in the reference. `Run` builds the model on the device with the
seeded weights and holds what a loop (``port_bench/loops/<loop>.py``, named
by the traffic mix) records: the set-up split, the window's numbers under
the names of the end-to-end metrics (`out`), and the program's outputs the
check compares. After the window the program's state is freed and the
reference works everything out again from the seed.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from . import traffic as T
from .trace import HostRanges
from .weights import make_weights, spec_of

__all__ = ["Run", "no_tf32", "sync"]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """State of one run: the cell's configuration, mix and seed."""

    def __init__(self, cfg: dict, mix: dict, seed: int, seconds: float, device, *,
                 t_process: float = None):
        self.cfg, self.seed, self.seconds = cfg, int(seed), float(seconds)
        self.mix = T.resolve(mix, cfg["yaml"])
        self.device = torch.device(device)
        self.t_process = time.perf_counter() if t_process is None else t_process
        self.setup: Dict[str, float] = {}
        self.out: Dict[str, object] = {}
        self.codes: List[torch.Tensor] = []
        self._arm = None
        self.ranges = HostRanges()

    def mark(self, key, t0):
        self.setup[key] = self.setup.get(key, 0.0) + time.perf_counter() - t0

    def build(self, meta: bool = False):
        """The program's model on the device with the seeded weights; with
        `meta` only its parameter list (the control needs no program)."""
        t0 = time.perf_counter()
        self.setup["start_s"] = t0 - self.t_process
        from speechclip_plus_tpu_torch.config import ConfigNode
        from speechclip_plus_tpu_torch.models.kwclip import (KWClip, KWClipConfig,
                                                               init_kw_bn_from_token_embedding)
        self.mark("import_s", t0)
        clip = self.cfg["arch"]["clip"]
        self.node = ConfigNode(self.cfg["yaml"])
        mcfg = KWClipConfig.from_config(self.node, vocab_size=clip["vocab_size"],
                                        sot_id=clip["sot_id"], eot_id=clip["eot_id"])
        if meta:
            with torch.device("meta"):
                self.spec = spec_of(KWClip(mcfg))
            return
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from speechclip_plus_tpu_torch.utils.cuda_build import kernels
            kernels()
        self.mark("kernels_s", t0)
        t0 = time.perf_counter()
        with torch.device(self.device):
            model = KWClip(mcfg)
        self.spec = spec_of(model)
        weights = make_weights(self.spec, self.seed, self.device)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name in weights:
                    p.copy_(weights[name])
        del weights
        init_kw_bn_from_token_embedding(model)
        self.model, self.mcfg = model.eval(), mcfg
        self._watch_keywords()
        sync(self.device)
        self.mark("build_s", t0)

    def images(self) -> torch.Tensor:
        return T.image_batch(self.seed, int(self.mix["images"]),
                             int(self.cfg["arch"]["clip"]["image_resolution"]), self.device)

    # ------------------------------------------------------- keyword codes --
    def _watch_keywords(self):
        """Records the keyword codes the program's vector quantizer chooses
        while armed (`arm_keywords`); a model without a keyword head records
        none."""
        branch = getattr(self.model, "cascaded_branch", None)
        if branch is None or not hasattr(branch, "head"):
            return
        vq = branch.head.vector_quantizer
        inner = vq.forward

        def forward(*a, **k):
            res = inner(*a, **k)
            training = a[3] if len(a) > 3 else k.get("training", False)
            if self._arm is not None and self._arm[0] == bool(training) and \
                    len(self.codes) < self._arm[1]:
                self.codes.append(res["targets"].detach().reshape(-1).clone())
            return res

        vq.forward = forward

    def arm_keywords(self, calls: int, training: bool):
        """Records the codes of the next `calls` quantizer calls in training
        (or serving) mode, one (B * K,) tensor a call, into `self.codes`."""
        self.codes, self._arm = [], (bool(training), int(calls))

    # ------------------------------------------------------------- memory --
    def reset_peak(self):
        if self.device.type == "cuda":
            self.run_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def read_peak(self):
        if self.device.type == "cuda":
            window_peak = torch.cuda.max_memory_allocated(self.device)
            self.out["peak_window_bytes"] = window_peak
            self.out["memory_peak_bytes"] = max(window_peak, self.run_peak)

    def free(self):
        self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- reference --
    def reference_model(self, prec: str = "fp32"):
        """The reference over weights made again from the seed."""
        from ..reference.model import Model, Prec, kw_bn_init, log_inv_temp

        W = {n: t.float() for n, t in make_weights(self.spec, self.seed, self.device).items()}
        kw_bn_init(W, self.cfg["arch"])
        W["criterion_log_inv_temp"] = log_inv_temp(
            float(self.cfg["yaml"]["cl_loss"]["args"]["temperature"])).to(self.device)
        return Model(W, self.cfg["arch"], Prec(prec))


class no_tf32:
    """float32 products in float32: TF32 off for matmuls and cuDNN."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
