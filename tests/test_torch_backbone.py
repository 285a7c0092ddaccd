"""forward_features (ResNet-50 body + FPN, P2..P6) of the PyTorch port
against detectron_tpu's on the tiny configuration's 256 x 320 canvas, with
the same params (JAX init carried over by the bridge) and images. Random
MSRA weights without trained BN statistics let activations grow by orders
of magnitude through the body, so each level is compared relative to its
largest value: float32 to 1e-4, bfloat16 (COMPUTE_DTYPE) to 5e-2, which
covers bf16 rounding compounded over 53 convolutions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from detectron_tpu.core import config as jax_config
from detectron_tpu.models import model_builder as jax_mb
from detectron_tpu_torch.models import bridge
from detectron_tpu_torch.models import model_builder as port_mb

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_params():
    _tiny_cfg(batch=2)
    return jax_mb.init_model(jax.random.PRNGKey(0))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-2)])
def test_forward_features_matches_jax(jax_params, dtype, tol):
    _tiny_cfg(batch=2)
    jax_config.merge_cfg_from_list(["TPU.COMPUTE_DTYPE", dtype])
    images = np.random.RandomState(0).randn(2, 256, 320, 3).astype(
        np.float32) * 20.0
    # A fresh function per dtype: jit traces read the global cfg.
    ref, ref_scales = jax.jit(lambda p, x: jax_mb.forward_features(p, x))(
        jax_params, jnp.asarray(images))
    params = bridge.to_torch(jax.tree.map(np.asarray, jax_params),
                             dtype=getattr(torch, dtype))
    with torch.no_grad():
        got, scales = port_mb.forward_features(params,
                                               torch.from_numpy(images))
    assert list(scales) == list(ref_scales)
    assert len(got) == len(ref) == 5
    for lvl, (g, r) in enumerate(zip(got, ref), start=2):
        r = np.asarray(jnp.asarray(r, jnp.float32))
        assert g.dtype == getattr(torch, dtype)
        assert tuple(g.shape) == r.shape == (
            2, 256 // 2 ** lvl, 320 // 2 ** lvl, 256), lvl
        err = np.abs(g.float().numpy() - r).max() / np.abs(r).max()
        assert err < tol, (lvl, err)
