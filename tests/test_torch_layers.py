"""The PyTorch port's NN primitives (detectron_tpu_torch/models/layers.py)
against detectron_tpu/models/layers.py on the same numpy inputs, NHWC in
and out, one parametrised test per op. float32 agrees to 1e-5 (sums in
another order); bfloat16 to 2e-2 relative (both round activations to bf16,
at different points inside a convolution)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.models import layers as jax_layers
from detectron_tpu_torch.models import bridge
from detectron_tpu_torch.models import layers as port_layers

torch.set_num_threads(2)

DTYPES = ["float32", "bfloat16"]


def _inputs(seed, x_shape, params, dtype):
    rng = np.random.RandomState(seed)
    x = rng.randn(*x_shape).astype(np.float32)
    p = {k: rng.randn(*s).astype(np.float32) for k, s in params.items()}
    jp = jax.tree.map(jnp.asarray, p)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jp, jx, p, tx


def _close(got, ref, dtype):
    tol = 1e-5 if dtype == "float32" else 2e-2
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol,
                               atol=tol * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,stride,pad,dil,bias", [
    (7, 2, 3, 1, False),            # stem
    (1, 2, 0, 1, False),            # strided 1x1 (STRIDE_1X1 bottleneck)
    (3, 1, 1, 1, True),             # FPN posthoc / RPN conv
    (3, 1, 2, 2, True),             # dilated mask-head conv
    (3, 1, ((0, 1), (1, 2)), 1, True),   # explicit asymmetric pads
])
def test_conv2d(k, stride, pad, dil, bias, dtype):
    params = {"w": (k, k, 6, 5)}
    if bias:
        params["b"] = (5,)
    jp, jx, p, tx = _inputs(k + stride + dil, (2, 11, 13, 6), params, dtype)
    ref = jax_layers.conv2d(jp, jx, stride=stride, padding=pad,
                            dilation=dil)
    got = port_layers.conv2d(bridge.to_torch({"conv": p}, "cpu")["conv"], tx,
                             stride=stride, padding=pad, dilation=dil)
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_transpose2d(dtype):
    jp, jx, p, tx = _inputs(1, (3, 7, 7, 6), {"w": (2, 2, 6, 5),
                                              "b": (5,)}, dtype)
    ref = jax_layers.conv_transpose2d(jp, jx, stride=2, torch_padding=0)
    got = port_layers.conv_transpose2d(
        bridge.to_torch({"deconv": p}, "cpu")["deconv"], tx, stride=2,
        torch_padding=0)
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fc(dtype):
    jp, jx, p, tx = _inputs(2, (9, 12), {"w": (12, 7), "b": (7,)}, dtype)
    _close(port_layers.fc(bridge.to_torch(p, "cpu"), tx), jax_layers.fc(jp, jx),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_affine_channel(dtype):
    jp, jx, p, tx = _inputs(3, (2, 4, 5, 6), {"s": (6,), "b": (6,)}, dtype)
    _close(port_layers.affine_channel(bridge.to_torch(p, "cpu"), tx),
           jax_layers.affine_channel(jp, jx), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw", [(10, 12), (11, 9)])
def test_max_pool(hw, dtype):
    """3x3 stride-2 pool with -inf padding 1, even and odd sizes."""
    _, jx, _, tx = _inputs(4, (2,) + hw + (3,), {}, dtype)
    _close(port_layers.max_pool(tx, 3, 2, 1),
           jax_layers.max_pool(jx, window=3, stride=2,
                               padding=((1, 1), (1, 1))), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_relu(dtype):
    _, jx, _, tx = _inputs(5, (2, 3, 4, 5), {}, dtype)
    _close(port_layers.relu(tx), jax_layers.relu(jx), dtype)
