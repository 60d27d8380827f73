"""SupConLoss and the CIF variants of the PyTorch port against the JAX package.

Op level: `supcon_loss` against JAX's with labels, a `valid` row mask and both
contrast modes, its value and its gradients into the features and the
temperature (rtol 1e-5, atol 1e-6: fp32, a few hundred terms).

Model level (`config/dev/tiny.yaml`, fp32, dropout off, the JAX variables
moved through `checkpoint/from_jax.py`; helpers from
`test_torch_trainable_towers.py`), the loss and the gradient of every
trainable tensor (rtol 1e-4 and 5e-5 x the tensor's largest |gradient|) of
one model that holds this file's keys: `cl_loss.type: SupConLoss`, CIF's
`using_gt_len` (the target length is the caption's EOT position - 1, here 3,
1 and 2) and `produce_weight_type: dense` with `cif_output_dim: 24` (of 32).
The third CIF variant, `conv_cif_layer_num: 2`, is held against JAX in
`test_torch_vq_variants.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_plus_tpu.ops.losses import supcon_loss as jax_supcon

from speechclip_plus_tpu_torch.config import load_config
from speechclip_plus_tpu_torch.models.kwclip import KWClipConfig
from speechclip_plus_tpu_torch.ops.losses import supcon_loss
from test_torch_trainable_towers import (TINY, compare_grads, jax_grads, make_batch, port_grads,
                                         set_keys, setup_pair)

CIF = "model_settings.cascaded_branch.downsampling.cif."
KEYS = {"cl_loss.type": "SupConLoss", CIF + "using_gt_len": True,
        CIF + "produce_weight_type": "dense", CIF + "cif_output_dim": 24}


@pytest.mark.parametrize("mode", ["all", "one"])
@pytest.mark.parametrize("masked", [False, True])
def test_supcon_loss_matches_jax(mode, masked):
    rng = np.random.RandomState(0)
    feats = rng.randn(6, 2, 8).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    labels = np.array([0, 1, 0, 2, 3, 1])
    valid = np.array([1, 1, 1, 1, 0, 1], bool) if masked else None
    kw = dict(base_temperature=0.07, contrast_mode=mode)

    def jfun(f, t):
        return jax_supcon(f, jnp.asarray(labels), temperature=t, valid=None if valid is None
                          else jnp.asarray(valid), **kw)

    jl, jg = jax.value_and_grad(jfun, argnums=(0, 1))(jnp.asarray(feats), jnp.float32(0.1))
    f, t = torch.tensor(feats, requires_grad=True), torch.tensor(0.1, requires_grad=True)
    loss = supcon_loss(f, torch.from_numpy(labels), temperature=t,
                       valid=None if valid is None else torch.from_numpy(valid), **kw)
    pg = torch.autograd.grad(loss, (f, t))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-6)
    for a, b in zip(pg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    if masked:  # the padded row takes no part: its features get no gradient
        assert float(pg[0][4].abs().max()) == 0.0


@pytest.fixture(scope="module")
def pair():
    _, model, variables, port, _ = setup_pair(KEYS)
    batch = make_batch()
    return model, variables, port, batch, jax_grads(model, variables, batch)


def test_supcon_and_cif_variants_match_jax(pair):
    model, variables, port, batch, (jlosses, jgrads) = pair
    assert port.cfg.cl_loss.type == "SupConLoss"
    losses, pgrads = port_grads(port, batch)
    for key in ("loss", "c_cl_loss", "p_cl_loss", "quantity_loss"):
        np.testing.assert_allclose(losses[key], float(jlosses[key]), rtol=1e-5, err_msg=key)
    compare_grads(port, variables, jgrads, pgrads)
    cif = port.cascaded_branch.downsampling
    assert hasattr(cif, "dense_proj") and not hasattr(cif, "conv")
    assert cif.cif_output_proj.weight.shape == (24, 32)
    assert port.cascaded_branch.head.linear_proj.in_features == 24


def test_gt_len_target_is_the_caption_length(pair):
    model, variables, port, batch, (jlosses, _) = pair
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss_feats, _, _ = port(tb, training=True, global_step=0)
    assert loss_feats["cif_target_len"].tolist() == [3, 1, 2]
    assert np.asarray(jlosses["cif_target_len"]).tolist() == [3, 1, 2]
    # without `text` in the batch the frame rule applies, as in JAX
    del tb["text"]
    loss_feats, _, _ = port(tb, training=True, global_step=0)
    want = torch.round(torch.tensor([3200, 2400, 2900]) / 4 / 20.0).long()
    assert torch.equal(loss_feats["cif_target_len"], want)


def test_cif_variants_parse_as_jax():
    from speechclip_plus_tpu.config import load_config as jax_load_config
    from speechclip_plus_tpu.models.kwclip import KWClipConfig as JKWClipConfig

    for keys in (KEYS, {CIF + "conv_cif_layer_num": 2, CIF + "cif_output_dim": 24}):
        mc = KWClipConfig.from_config(set_keys(load_config(TINY), keys))
        jc = JKWClipConfig.from_config(set_keys(jax_load_config(TINY), keys))
        for f in ("produce_weight_type", "num_layer", "cif_output_dim", "using_gt_len"):
            assert getattr(mc.cif, f) == getattr(jc.cif, f), f
        assert mc.using_gt_len == jc.using_gt_len
        for f in ("type", "base_temperature", "contrast_mode"):
            assert getattr(mc.cl_loss, f) == getattr(jc.cl_loss, f), f
