"""Reference PyTorch state dicts -> the port's module state dicts.

Port of ``speechclip_plus_tpu/checkpoint/torch_import.py``. There a torch
state dict becomes a Flax pytree (kernels transposed); here the reference's
modules and the port's are both PyTorch, so an import is a set of key
renames, and packing three separate q / k / v projections into one
`in_proj` where the reference keeps them apart. Every helper reads
`{name: array}` dicts (`load_torch_state_dict`) and writes numpy arrays under
the port's names into `out`; a key it expects and does not find raises
`KeyError` naming it. `load_port_state_dict` puts the result into a module,
strict both ways.

`trusted_torch_load` is the one place in the port that unpickles with
`weights_only=False` (Lightning and fairseq files pickle their arguments
beside the tensors; a shim class stands in for avssl's `OrderedNamespace`).
Unpickling runs arbitrary code from the file, so load only trusted files.
"""
from __future__ import annotations

import io
import pickle
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = [
    "to_numpy",
    "copy_weight_bias",
    "copy_batchnorm",
    "copy_packed_mha",
    "pack_qkv",
    "load_port_state_dict",
    "load_torch_state_dict",
    "trusted_torch_load",
]


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        x = x.numpy()
    return np.asarray(x)


def _get(sd: Mapping, key: str) -> np.ndarray:
    if key not in sd:
        raise KeyError(f"reference key missing: {key}")
    return to_numpy(sd[key])


def copy_weight_bias(out: Dict, dst: str, sd: Mapping, src: str, bias: bool = True) -> None:
    """A Linear, a convolution, a LayerNorm or a GroupNorm: the same names and
    layouts in both (`bias=False`: a convolution without bias)."""
    out[f"{dst}weight"] = _get(sd, f"{src}weight")
    if bias:
        out[f"{dst}bias"] = _get(sd, f"{src}bias")


def copy_batchnorm(out: Dict, dst: str, sd: Mapping, src: str) -> None:
    """BatchNorm1d: weight, bias and the running statistics (the reference's
    `num_batches_tracked` has no counterpart: the momentum is fixed)."""
    copy_weight_bias(out, dst, sd, src)
    for stat in ("running_mean", "running_var"):
        out[f"{dst}{stat}"] = _get(sd, f"{src}{stat}")


def copy_packed_mha(out: Dict, dst: str, sd: Mapping, src: str) -> None:
    """torch `nn.MultiheadAttention`: `in_proj_weight` (3D, D) in q, k, v
    order, `in_proj_bias` and `out_proj`; the port keeps the same layout."""
    for key in ("in_proj_weight", "in_proj_bias"):
        out[f"{dst}{key}"] = _get(sd, f"{src}{key}")
    copy_weight_bias(out, f"{dst}out_proj.", sd, f"{src}out_proj.")


def pack_qkv(out: Dict, dst: str, sd: Mapping, src: str) -> None:
    """Separate `q_proj` / `k_proj` / `v_proj` (fairseq and HF attention) into
    the port's packed, unscaled `in_proj_weight` / `in_proj_bias` in q, k, v
    order (the kernel applies 1/sqrt(dh) itself), and `out_proj`."""
    for key in ("weight", "bias"):
        out[f"{dst}in_proj_{key}"] = np.concatenate(
            [_get(sd, f"{src}{n}_proj.{key}") for n in "qkv"], axis=0)
    copy_weight_bias(out, f"{dst}out_proj.", sd, f"{src}out_proj.")


@torch.no_grad()
def load_port_state_dict(module: nn.Module, arrays: Mapping[str, np.ndarray]) -> None:
    """Copy `arrays` (port names relative to `module`) into its parameters and
    persistent buffers, cast to each tensor's dtype. Strict both ways: a
    tensor of the module left unfilled, a name the module does not have, or a
    shape mismatch raises `ValueError`."""
    target = module.state_dict(keep_vars=True)
    missing = sorted(set(target) - set(arrays))
    unexpected = sorted(set(arrays) - set(target))
    if missing or unexpected:
        raise ValueError(f"port tensors not filled: {missing}; names the port does not "
                         f"have: {unexpected}")
    for name, t in target.items():
        a = np.asarray(arrays[name])
        if tuple(t.shape) != a.shape:
            raise ValueError(f"{name}: port {tuple(t.shape)} vs reference {a.shape}")
    for name, t in target.items():
        t.copy_(torch.from_numpy(np.array(arrays[name])))


class _NamespaceShim:
    """Stand-in for avssl's OrderedNamespace during unpickling."""

    def __setstate__(self, state):
        self.state = state


class _ShimUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "OrderedNamespace":
            return _NamespaceShim
        return super().find_class(module, name)


class _ShimPickleModule:
    """pickle module facade whose Unpickler substitutes OrderedNamespace."""

    Unpickler = _ShimUnpickler
    load = staticmethod(lambda f, **kw: _ShimUnpickler(f, **kw).load())
    loads = staticmethod(lambda b, **kw: _ShimUnpickler(io.BytesIO(b), **kw).load())


def trusted_torch_load(path: str):
    """`torch.load` of a trusted file that pickles more than tensors (a
    Lightning or fairseq checkpoint), on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_ShimPickleModule)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load any torch checkpoint into a flat numpy state dict (the
    `state_dict`, `model` or `model_state_dict` entry when there is one).
    fairseq files pickle their arguments beside the weights, so the file is
    unpickled by `trusted_torch_load`: load only trusted files."""
    obj = trusted_torch_load(path)
    if isinstance(obj, dict):
        for key in ("state_dict", "model", "model_state_dict"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    return {k: to_numpy(v) for k, v in obj.items()
            if isinstance(v, (torch.Tensor, np.ndarray))}
