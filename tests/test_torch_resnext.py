"""ResNeXt and the deeper ResNet bodies in the PyTorch port against the JAX
package, and init_model's tree for every yaml under configs/.

- Grouped bottleneck stages (a block with its shortcut at stride 2, then a
  plain one) for the 32x8d and 64x4d plans, float32 within 1e-5 and
  bfloat16 within 2e-2 of max|ref| (both sum in other orders; bf16
  rounds at other places).
- init_model: for each of the 30 yamls, check_model_supported passes and
  the tree has the JAX package's keys and shapes (the JAX init under
  jax.eval_shape, so nothing is computed; the port's fills replaced by
  empty arrays of their shapes).
- X-152-32x8d and R-101 FPN features at 64 x 64, float32 within 1e-4 of
  each level's max|ref| (33-50 blocks of float32 sums in other orders),
  from the port's numpy init given to both packages.
- detect_graph of a tiny ResNeXt Mask R-CNN (test_torch_util.RESNEXT_KEYS),
  test_torch_detect.py's matching.
- One training step of that model (MASK_ON off) with TPU.REMAT_BODY on,
  at 2 x 64 x 64
  (test_torch_train_step.py's batch, tolerances and draws): losses to
  rtol 1e-4, gradients within 1e-3 of each leaf's max|g| of JAX's (also
  under jax.checkpoint); the port's gradients with REMAT_BODY on and off
  bit-equal (under torch.use_deterministic_algorithms, which fixes the
  CPU's index_put_ order).
- Weight import: to_detectron_blobs -> load_detectron_weight for X-101
  and X-152 trees (exact, grouped blobs (O, I / 32, 3, 3)); the ImageNet
  loader on a grouped Detectron .pkl written here; R-101 / X-152's FPN
  blob names carry the stages' top block index. These trees have their
  yaml's depth and 32 groups at NARROW's widths (4 channels a group, a
  64-wide fc head: names and layouts do not depend on widths, and the
  full widths' 1.4 x 10^8 values took ~5 s a tree), filled with distinct
  ramps (_ramp_fill: every leaf and element its own value, a transposed
  or swapped blob shows).
The models' params are the port's numpy init_model, given to both
packages (the JAX init of these models takes ~15 s on the CPU), and the
JAX models run their plain RoIAlign and NMS paths
(test_torch_util.jax_plain_paths). Each JAX function is jitted afresh per
cfg (a trace reads the global cfg).
"""

import glob
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.core import config as jax_config
from detectron_tpu.core import test as jax_test
from detectron_tpu.models import model_builder as jax_mb
from detectron_tpu.models import resnet as jax_resnet
from detectron_tpu.parallel import optimizer as jax_opt
from detectron_tpu_torch.core import config as port_config
from detectron_tpu_torch.core import test as port_test
from detectron_tpu_torch.models import bridge
from detectron_tpu_torch.models import init as port_init
from detectron_tpu_torch.models import model_builder as port_mb
from detectron_tpu_torch.models import resnet as port_resnet
from detectron_tpu_torch.models import train_graph as port_tg
from detectron_tpu_torch.parallel import optimizer as port_opt
from detectron_tpu_torch.parallel import train_step as port_ts
from detectron_tpu_torch.utils import detectron_weight_helper as dwh
from detectron_tpu_torch.utils import resnet_weights_helper as rwh
from detectron_tpu_torch.utils.synthetic import calibrate_detector_params
from test_torch_detect import _assert_detections_match
from test_torch_train_step import (_batch, _close_tree, _jax_step,
                                   _replay_draws)
from test_torch_util import (RESNEXT_KEYS, ROOT, TRAIN_KEYS,
                             jax_plain_paths, set_cfgs)

torch.set_num_threads(4)

YAMLS = sorted(glob.glob(str(ROOT / "configs" / "**" / "*.yaml"),
                         recursive=True))
X152 = str(ROOT / "configs" / "baselines" /
           "e2e_mask_rcnn_X-152-32x8d-FPN-IN5k_1.44x.yaml")
X101 = str(ROOT / "configs" / "baselines" /
           "e2e_mask_rcnn_X-101-32x8d-FPN_1x.yaml")


def _load_yaml(path):
    """Both packages' cfgs from one yaml."""
    jax_config.reset_cfg()
    jax_config.merge_cfg_from_file(path)
    jax_config.assert_and_infer_cfg(make_immutable=False)
    port_config.reset_cfg()
    port_config.merge_cfg_from_file(path)
    port_config.assert_and_infer_cfg(make_immutable=False)


def _err(got, ref):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("groups,width", [(32, 8), (64, 4)])
def test_grouped_stage_matches_jax(groups, width, dtype, tol):
    set_cfgs(extra=["RESNETS.NUM_GROUPS", str(groups),
                    "RESNETS.WIDTH_PER_GROUP", str(width),
                    "RESNETS.STRIDE_1X1", "False"])
    inner, outer, ng = port_resnet.inner_dims()
    assert inner[0] == groups * width == 256 and ng == groups
    blocks = jax.tree.map(np.array, jax_resnet.init_stage(
        jax.random.PRNGKey(groups), 2, 64, outer[0], inner[0],
        groups=groups))
    assert blocks[0]["branch2b"]["w"].shape == (3, 3, width, 256)
    x = np.random.RandomState(width).randn(2, 12, 10, 64).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jax.jit(lambda p, a: jax_resnet.apply_stage(p, a, 2, groups=ng))(
        jax.tree.map(lambda a: jnp.asarray(a, jd), blocks),
        jnp.asarray(x, jd))
    td = getattr(torch, dtype)
    got = port_resnet.apply_stage(bridge.to_torch(blocks, "cpu", td),
                                  torch.from_numpy(x).to(td), 2)
    assert got.dtype == td and tuple(got.shape) == ref.shape == (2, 6, 5,
                                                                256)
    assert _err(got, ref) <= tol


def _spec_only(rng, shape, weight_init, std=0.01):
    return np.empty(shape, np.float32)


@pytest.mark.parametrize("path", YAMLS,
                         ids=[os.path.basename(p) for p in YAMLS])
def test_init_model_matches_jax_for_every_yaml(path, monkeypatch):
    _load_yaml(path)
    port_init.check_model_supported()
    ref = jax.eval_shape(lambda k: jax_mb.init_model(k),
                         jax.random.PRNGKey(0))
    ref = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p):
           a.shape for p, a in jax.tree_util.tree_flatten_with_path(ref)[0]}
    monkeypatch.setattr(port_init, "_fill", _spec_only)
    got = {p: a.shape for p, a in port_opt.flatten(port_init.init_model(0))}
    assert set(got) == set(ref)
    assert all(got[p] == ref[p] for p in ref)


def test_yamls_cover_the_model_families():
    assert len(YAMLS) == 30
    bodies = set()
    for path in YAMLS:
        port_config.reset_cfg()
        port_config.merge_cfg_from_file(path)
        bodies.add((port_resnet.body_spec(port_config.cfg.MODEL.CONV_BODY),
                    port_config.cfg.RESNETS.NUM_GROUPS,
                    port_config.cfg.RESNETS.USE_GN))
    assert {((50, 3), 1, False), ((50, 4), 1, True), ((101, 4), 1, False),
            ((101, 4), 32, False), ((101, 4), 64, False),
            ((152, 4), 32, False)} <= bodies


def _fast_fill(rng, shape, weight_init, std=0.01):
    """init's fills, drawn in float32 by a numpy Generator (a third of the
    time of RandomState's float64 draws for X-152's 10^8 values)."""
    gen = np.random.default_rng(rng.randint(1 << 30))
    fan_in, fan_out = port_init._fans(shape)
    if weight_init == "XavierFill":
        scale = np.float32(np.sqrt(3.0 / fan_in))
        return gen.uniform(-scale, scale, shape).astype(np.float32)
    if weight_init == "MSRAFill":
        std = np.sqrt(2.0 / fan_out)
    return np.float32(std) * gen.standard_normal(shape, np.float32)


R101 = str(ROOT / "configs" / "baselines" / "e2e_mask_rcnn_R-101-FPN_1x.yaml")


@pytest.mark.parametrize("yaml,depth,branch2b", [
    (X152, 152, (3, 3, 32, 1024)), (R101, 101, (3, 3, 256, 256))],
    ids=["X-152", "R-101"])
def test_deep_fpn_features_match_jax(yaml, depth, branch2b, monkeypatch):
    _load_yaml(yaml)
    monkeypatch.setattr(port_init, "_fill", _fast_fill)
    rng = np.random.RandomState(0)
    tree = {"body": port_init.init_body(rng, depth, 4),
            "fpn": port_init.init_fpn(rng)}
    assert len(tree["body"]["res4"]) == port_resnet.BLOCK_COUNTS[depth][2]
    assert tree["body"]["res4"][0]["branch2b"]["w"].shape == branch2b
    x = np.random.RandomState(1).randn(1, 64, 64, 3).astype(np.float32)
    ref, _ = jax.jit(lambda p, a: jax_mb.forward_features(p, a))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    with torch.no_grad():
        got, scales = port_mb.forward_features(bridge.to_torch(tree, "cpu"),
                                               torch.from_numpy(x))
    assert scales == [0.25, 0.125, 0.0625, 0.03125, 0.015625]
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    assert tuple(got[0].shape) == (1, 16, 16, 256)
    for g, r in zip(got, ref):
        assert _err(g, r) <= 1e-4


IM_INFO = np.array([[250.0, 310.0, 1.0], [200.0, 300.0, 1.0]], np.float32)


def test_resnext_detect_graph_matches_jax():
    set_cfgs(extra=RESNEXT_KEYS)
    jax_plain_paths()
    tree = calibrate_detector_params(port_init.init_model(0),
                                     np.random.RandomState(0))
    # ResNeXt's random-init features stay small (std ~4 at res5), so the
    # class logits barely move from their biases: spread them.
    tree["box_outs"]["cls_score"]["w"] *= 30.0
    images = np.random.RandomState(0).randn(2, 256, 320, 3).astype(
        np.float32) * 20.0
    ref = jax.jit(lambda p, x, i: jax_test.detect_graph(p, x, i))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(images),
        jnp.asarray(IM_INFO))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = port_test.detect_graph(bridge.to_torch(tree, "cpu"),
                                 torch.from_numpy(images),
                                 torch.from_numpy(IM_INFO))
    assert set(got) == set(ref)
    assert ref["valid"].sum() > 4
    _assert_detections_match(got, ref, mask_atol=1e-4)


@pytest.fixture(scope="module")
def remat_step():
    """One JAX train step of the tiny ResNeXt (Faster R-CNN: the body is
    the point) with TPU.REMAT_BODY (jax.checkpoint per stage), jitted
    once."""
    keys = TRAIN_KEYS + RESNEXT_KEYS + ["TPU.REMAT_BODY", "True"]
    set_cfgs(mask_on=False, extra=keys)
    jax_plain_paths()
    # jax.tree.map orders the dict keys as JAX's gradients come.
    tree = jax.tree.map(np.asarray, port_init.init_model(0))
    batch = _batch(False)
    key = jax.random.PRNGKey(1)
    jp = jax.tree.map(jnp.asarray, tree)
    total, parts, grads, _, _ = jax.jit(_jax_step)(
        jp, jax_opt.init_opt_state(jp), jax.tree.map(jnp.asarray, batch),
        key)
    n_anchors, n_rois = port_tg.draw_sizes((64, 64), 8)
    return dict(keys=keys, tree=tree, total=total, parts=parts, grads=grads,
                batch={k: torch.from_numpy(v) for k, v in batch.items()},
                draws=_replay_draws(key, n_anchors, n_rois))


def test_resnext_remat_train_step_matches_jax(remat_step):
    c = remat_step
    set_cfgs(mask_on=False, extra=c["keys"])
    params = bridge.to_torch(c["tree"], "cpu")
    torch.use_deterministic_algorithms(True)
    try:
        total, parts, grads = port_ts.loss_and_grads(params, c["batch"],
                                                     c["draws"])
        port_config.cfg.TPU.REMAT_BODY = False
        total_off, _, grads_off = port_ts.loss_and_grads(
            params, c["batch"], c["draws"])
    finally:
        torch.use_deterministic_algorithms(False)
    assert set(parts) == set(c["parts"]) and "loss_rpn_cls" in parts
    for k, v in c["parts"].items():
        np.testing.assert_allclose(float(parts[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(total), float(c["total"]), rtol=1e-4)
    _close_tree(bridge.to_jax_layout(grads), c["grads"], 1e-3, "grad")
    # Recomputing the stages in the backward changes no bit.
    assert torch.equal(total, total_off)
    for (path, a), (_, b) in zip(port_opt.flatten(grads),
                                 port_opt.flatten(grads_off)):
        assert torch.equal(a, b), path
    g = grads["body"]["res3"][0]["branch2b"]["w"]
    assert g.shape == (512, 16, 3, 3) and float(g.abs().max()) > 0


def test_remat_skips_stages_without_gradient(monkeypatch):
    """Checkpointing runs only where a gradient flows: not under no_grad,
    and not on frozen stages (FREEZE_AT 2: res2) whose input needs none."""
    set_cfgs(extra=RESNEXT_KEYS + ["TPU.REMAT_BODY", "True"])
    calls = []
    real = port_resnet.checkpoint

    def spy(fn, sp, h, *args, **kw):
        calls.append(sp[0]["branch2c"]["w"].shape[0])
        return real(fn, sp, h, *args, **kw)

    monkeypatch.setattr(port_resnet, "checkpoint", spy)
    rng = np.random.RandomState(0)
    body = bridge.to_torch(port_init.init_body(rng, 50, 4), "cpu")
    p, _ = port_ts.grad_leaves({"body": body})
    x = torch.from_numpy(np.random.RandomState(1).randn(
        1, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        port_resnet.apply_body(p["body"], x, 4)
    assert calls == []
    outs = port_resnet.apply_body(p["body"], x, 4)
    assert calls == [512, 1024, 2048]
    outs[-1].sum().backward()


def _ramp_fill(rng, shape, weight_init, std=0.01):
    """A leaf of distinct values, distinct from every other leaf's."""
    n = int(np.prod(shape))
    start = rng.randint(1 << 20)
    return (np.arange(start, start + n, dtype=np.float64) / (1 << 24)) \
        .astype(np.float32).reshape(shape)


def _empty_tree():
    """init_model's tree of the cfg, unfilled: a target for loading."""
    fill = port_init._fill
    port_init._fill = _spec_only
    try:
        return port_init.init_model(1)
    finally:
        port_init._fill = fill


NARROW = ["RESNETS.WIDTH_PER_GROUP", "4", "FAST_RCNN.MLP_HEAD_DIM", "64"]


def _load_narrow(path):
    """The port's cfg from a yaml, at NARROW's widths."""
    port_config.reset_cfg()
    port_config.merge_cfg_from_file(path)
    port_config.merge_cfg_from_list(NARROW)
    port_config.assert_and_infer_cfg(make_immutable=False)


def _round_trip(path, tmp_path):
    _load_narrow(path)
    tree = port_init.init_model(0)
    pkl = str(tmp_path / "model.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"blobs": dwh.to_detectron_blobs(tree)}, f,
                    pickle.HIGHEST_PROTOCOL)
    back = dict(port_opt.flatten(dwh.load_detectron_weight(
        _empty_tree(), pkl)))
    for p, a in port_opt.flatten(tree):
        np.testing.assert_array_equal(back[p], a, err_msg=str(p))
    return tree, pkl


@pytest.mark.parametrize("yaml", [X101, X152], ids=["X-101", "X-152"])
def test_resnext_weights_round_trip(yaml, tmp_path, monkeypatch):
    monkeypatch.setattr(port_init, "_fill", _ramp_fill)
    tree, pkl = _round_trip(yaml, tmp_path)
    blobs = dwh.read_blobs(pkl)
    depth = port_resnet.body_spec(port_config.cfg.MODEL.CONV_BODY)[0]
    top = port_resnet.BLOCK_COUNTS[depth][2] - 1
    assert port_config.cfg.RESNETS.NUM_GROUPS == 32
    assert blobs["res4_{}_branch2b_w".format(top)].shape == (512, 16, 3, 3)
    assert "fpn_inner_res4_{}_sum_lateral_w".format(top) in blobs
    assert "res4_{}_branch2c_bn_s".format(top) in blobs


def test_imagenet_weights_from_a_grouped_pkl(tmp_path, monkeypatch):
    """A Detectron-format X-101-32x8d ImageNet .pkl (body blobs only, as
    Detectron ships them) fills the body exactly and nothing else."""
    monkeypatch.setattr(port_init, "_fill", _ramp_fill)
    _load_narrow(X101)
    tree = port_init.init_model(0)
    body_blobs = {k: v for k, v in dwh.to_detectron_blobs(tree).items()
                  if k in dwh.body_weight_mapping(101, 4)}
    pkl = str(tmp_path / "X-101-32x8d.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"blobs": body_blobs}, f, pickle.HIGHEST_PROTOCOL)
    fresh = port_init.init_model(1)
    before = dict(port_opt.flatten(fresh))
    got = dict(port_opt.flatten(rwh.load_pretrained_imagenet_weights(
        fresh, pkl)))
    ref = dict(port_opt.flatten(tree))
    for p in ref:
        want = ref[p] if p[0] == "body" else before[p]
        np.testing.assert_array_equal(got[p], want, err_msg=str(p))
    assert got[("body", "res2", 0, "branch2b", "w")].shape == (3, 3, 4, 128)
