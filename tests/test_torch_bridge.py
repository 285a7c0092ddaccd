"""The PyTorch port's params side against the JAX package: the numpy
init_model tree, the params bridge (conv HWIO -> OIHW, the flipped deconv,
the fc6 row order), the numpy calibration, and the port's freedom from
JAX."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.models import fast_rcnn_heads as jax_heads
from detectron_tpu.models import layers as jax_layers
from detectron_tpu.models import model_builder as jax_mb
from detectron_tpu.utils import synthetic as jax_synthetic
from detectron_tpu_torch.models import bridge
from detectron_tpu_torch.models import init as port_init
from detectron_tpu_torch.models import layers as port_layers
from detectron_tpu_torch.utils import synthetic as port_synthetic
from test_torch_util import set_cfgs

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_tree():
    set_cfgs()
    return jax.tree.map(np.asarray, jax_mb.init_model(jax.random.PRNGKey(0)))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_numpy_init_tree_matches_jax(jax_tree):
    """Same keys and shapes; the same fill per leaf (constants equal, random
    fills with the same spread)."""
    set_cfgs()
    ours = port_init.init_model(0)
    assert jax.tree.structure(ours) == jax.tree.structure(jax_tree)
    for (path, a), (_, b) in zip(_leaves(ours), _leaves(jax_tree)):
        assert a.shape == b.shape and a.dtype == np.float32, path
        if b.std() == 0:
            np.testing.assert_array_equal(a, b)
        elif b.size >= 1000:
            assert abs(a.std() / b.std() - 1) < 0.1, path


def test_every_leaf_bridged(jax_tree):
    set_cfgs()
    tt = bridge.to_torch(jax_tree, "cpu")
    assert jax.tree.structure(
        jax.tree.map(lambda t: 0, tt)) == jax.tree.structure(
        jax.tree.map(lambda a: 0, jax_tree))
    n = 0
    for (path, t), (_, a) in zip(_leaves(tt), _leaves(jax_tree)):
        keys = tuple(getattr(k, "key", getattr(k, "idx", None))
                     for k in path)
        t = t.numpy()
        if a.ndim == 4 and "deconv" in keys:
            np.testing.assert_array_equal(
                t, a[::-1, ::-1].transpose(2, 3, 0, 1))
        elif a.ndim == 4:
            np.testing.assert_array_equal(t, a.transpose(3, 2, 0, 1))
        elif keys[-3:] == ("box_head", "fc6", "w"):
            assert t.shape == a.shape
            np.testing.assert_array_equal(np.sort(t, 0), np.sort(a, 0))
        else:
            np.testing.assert_array_equal(t, a)
        n += 1
    assert n == len(_leaves(jax_tree)) > 200


def test_to_jax_layout_inverts_to_torch(jax_tree):
    """to_jax_layout(to_torch(t, "cpu")) is t exactly, for the full R-50-FPN
    Mask R-CNN tree."""
    set_cfgs()
    back = bridge.to_jax_layout(bridge.to_torch(jax_tree, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(jax_tree)
    for (path, a), (_, b) in zip(_leaves(back), _leaves(jax_tree)):
        assert a.dtype == np.float32 and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,pad", [(2, 0), (4, 1)])
def test_deconv_through_bridge_matches_jax(k, pad, dtype):
    """lax.conv_transpose(transpose_kernel=False) on the stored kernel ==
    F.conv_transpose2d on the bridged one."""
    rng = np.random.RandomState(k)
    x = rng.randn(2, 5, 6, 8).astype(np.float32)
    p = {"w": rng.randn(k, k, 8, 4).astype(np.float32),
         "b": rng.randn(4).astype(np.float32)}
    jd = getattr(jnp, dtype)
    ref = jax_layers.conv_transpose2d(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x, jd), stride=2,
        torch_padding=pad)
    tp = bridge.to_torch({"mask_head": {"deconv": p}},
                         "cpu")["mask_head"]["deconv"]
    got = port_layers.conv_transpose2d(
        tp, torch.from_numpy(x).to(getattr(torch, dtype)), stride=2,
        torch_padding=pad)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol * 10)


def test_fc6_rows_match_jax(jax_tree):
    """The bridged fc6 on (p, q, c)-flattened features equals JAX's
    _fc_on_nhwc on the Caffe2-ordered weight."""
    set_cfgs()
    p = {"w": jax_tree["box_head"]["fc6"]["w"],
         "b": np.random.RandomState(0).randn(1024).astype(np.float32)}
    x = np.random.RandomState(1).randn(3, 7, 7, 256).astype(np.float32)
    ref = jax_heads._fc_on_nhwc(jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x))
    tp = bridge.to_torch({"box_head": {"fc6": p}}, "cpu")["box_head"]["fc6"]
    got = port_layers.fc(tp, torch.from_numpy(x).reshape(3, -1))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_calibration_matches_jax(jax_tree):
    ref = jax_synthetic.calibrate_detector_params(
        jax.tree.map(jnp.asarray, jax_tree), np.random.RandomState(3))
    got = port_synthetic.calibrate_detector_params(
        jax.tree.map(np.array, jax_tree), np.random.RandomState(3))
    for (path, a), (_, b) in zip(_leaves(got), _leaves(ref)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))


def test_port_imports_no_jax():
    code = ("import sys, detectron_tpu_torch.core.test, chip_smoke, "
            "detectron_tpu_torch.parallel.train_step, "
            "detectron_tpu_torch.ops.cuda.fused_stem_kernel; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "bad = [m for m in sys.modules if m.split('.')[0] == "
            "'detectron_tpu']; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])
