"""GroupNorm models in the PyTorch port against the JAX package:
configs/gn_baselines' Mask R-CNN R-50-FPN (GN body, GN FPN, the
Xconv1fc_gn box head, the v1up4convs_gn mask head) at the tiny sizes of
test_torch_util.GN_KEYS, and the Xconv1fc head without GN.

- layers.group_norm (statistics and affine in float32, the input dtype
  out) and get_group_gn's two rules, float32 within 1e-5 of max|ref|,
  bfloat16 within an ulp of each value plus 1e-5 of max|ref| (both round
  one float32 result).
- The box heads (Xconv1fc with and without GN), the GN mask head and a
  GN res5 C4 head, float32 within 1e-5 and bfloat16 within 2e-2 of
  max|ref|.
- detect_graph of the tiny GN Mask R-CNN, test_torch_detect.py's
  matching.
- One training step at 2 x 64 x 64 (test_torch_train_step.py's batch,
  tolerances and draws), with FREEZE_AT 0 as the scratch yaml has it:
  losses, gradients (through a float64 step, past the ReLU sign trap:
  see test_gn_train_step_matches_jax), and the params after the SGD
  step; every GN param
  (the stem's and every stage's, the FPN's, both heads') gets a nonzero
  gradient and the update lr (g + SOLVER.WEIGHT_DECAY_GN p).
- Weight import: to_detectron_blobs -> load_detectron_weight exactly, with
  Detectron's ConvGN blob names (conv1_gn_s, res2_0_branch2a_gn_s,
  fpn_inner_res5_2_sum_gn_s, head_conv1_gn_s, _mask_fcn1_w); the JAX
  package's table does not name them and cannot load the file; an
  ImageNet R-50-GN .pkl fills the GN body, a caffe .pth raises.
The params are the port's numpy init_model, given to both packages, and
the JAX models run their plain RoIAlign and NMS paths
(test_torch_util.jax_plain_paths); each JAX function is jitted afresh per
cfg (a trace reads the global cfg).
"""

import copy
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.core import test as jax_test
from detectron_tpu.models import fast_rcnn_heads as jax_fh
from detectron_tpu.models import layers as jax_layers
from detectron_tpu.models import mask_rcnn_heads as jax_mh
from detectron_tpu.models import resnet as jax_resnet
from detectron_tpu.parallel import optimizer as jax_opt
from detectron_tpu.utils import detectron_weight_helper as jax_dwh
from detectron_tpu_torch.core import test as port_test
from detectron_tpu_torch.core.config import cfg as port_cfg
from detectron_tpu_torch.models import bridge
from detectron_tpu_torch.models import fast_rcnn_heads as port_fh
from detectron_tpu_torch.models import init as port_init
from detectron_tpu_torch.models import layers as port_layers
from detectron_tpu_torch.models import mask_rcnn_heads as port_mh
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
from test_torch_util import (C4_KEYS, GN_KEYS, TRAIN_KEYS,
                             jax_plain_paths, set_cfgs)

torch.set_num_threads(4)


def _sorted(tree):
    """The tree with its dicts in JAX's (sorted) key order."""
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _drawn(seed, extra):
    set_cfgs(extra=list(extra))
    return port_init.init_model(seed)


def _init_model(seed, extra=GN_KEYS):
    """set_cfgs(extra=extra), then a copy of init_model(seed), drawn once
    per (seed, extra): a draw of these 3-3.5 x 10^7 values takes ~1 s."""
    tree = _drawn(seed, tuple(extra))
    set_cfgs(extra=extra)
    return copy.deepcopy(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim_per_gp,num_groups", [(-1, 32), (16, -1)])
def test_group_norm_matches_jax(dim_per_gp, num_groups, dtype):
    C = 64
    g = port_layers.get_group_gn(C, dim_per_gp, num_groups)
    assert g == jax_layers.get_group_gn(C, dim_per_gp, num_groups)
    rng = np.random.RandomState(g)
    x = (rng.randn(2, 6, 5, C) * 3 + 1).astype(np.float32)
    p = {"s": rng.rand(C).astype(np.float32) + 0.5,
         "b": rng.randn(C).astype(np.float32)}
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = np.asarray(jnp.asarray(jax_layers.group_norm(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x, jd), g), jnp.float32))
    td = getattr(torch, dtype)
    got = port_layers.group_norm(
        {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x).to(td), g)
    assert got.dtype == td
    err = np.abs(got.float().numpy() - ref)
    ulp = 0.0 if dtype == "float32" else 1.0 / 128
    assert (err <= ulp * np.abs(ref) + 1e-5 * np.abs(ref).max()).all()


def test_get_group_gn_rejects_both_rules():
    with pytest.raises(ValueError, match="not both"):
        port_layers.get_group_gn(64, 16, 32)
    with pytest.raises(ValueError, match="64 channels in 3 groups"):
        port_layers.get_group_gn(64, -1, 3)


def _close(got, ref, tol):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= tol * np.abs(ref).max(), err


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("head", ["xconv", "xconv_gn", "mask_gn", "c4_gn"])
def test_gn_heads_match_jax(head, dtype, tol):
    """Each head on (6, P, P, C) RoI features: Xconv1fc without GN (the
    Caffe2 (C, P, P) fc6 rows through the bridge), with GN, the
    v1up4convs_gn mask head and its outputs, and a C4 res5 head with a GN
    body (RESNETS.USE_GN on the C4 preset)."""
    extra = {"xconv": ["FAST_RCNN.ROI_BOX_HEAD",
                       "fast_rcnn_heads.roi_Xconv1fc_head",
                       "FAST_RCNN.NUM_STACKED_CONVS", "2",
                       "FAST_RCNN.CONV_HEAD_DIM", "64",
                       "FAST_RCNN.MLP_HEAD_DIM", "32"],
             "c4_gn": C4_KEYS + ["RESNETS.USE_GN", "True"]}.get(head,
                                                                 GN_KEYS)
    tree = _init_model(3, extra)
    rng = np.random.RandomState(5)
    if head == "c4_gn":
        x = np.abs(rng.randn(6, 14, 14, 1024)).astype(np.float32)
    else:
        P = 14 if head == "mask_gn" else 7
        x = rng.randn(6, P, P, port_cfg.FPN.DIM).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a, jd), tree)
    params = bridge.to_torch(tree, "cpu", getattr(torch, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    if head.startswith("xconv"):
        assert ("gns" in tree["box_head"]) == (head == "xconv_gn")
        assert ("b" in tree["box_head"]["convs"][0]) == (head == "xconv")
        ref = jax.jit(jax_fh.apply_roi_Xconv1fc_head)(jp["box_head"],
                                                      jnp.asarray(x, jd))
        got = port_fh.apply_roi_Xconv1fc_head(params["box_head"], xt)
        assert got.shape == (6, port_cfg.FAST_RCNN.MLP_HEAD_DIM)
    elif head == "mask_gn":
        ref = jax.jit(lambda p, a: jax_mh.apply_mask_outputs(
            p["mask_outs"], jax_mh.apply_mask_head(p["mask_head"], a)))(
                jp, jnp.asarray(x, jd))
        got = port_mh.apply_mask_outputs(
            params["mask_outs"], port_mh.apply_mask_head(
                params["mask_head"], xt))
        assert got.shape == (6, 28, 28, port_cfg.MODEL.NUM_CLASSES)
    else:
        assert "s" in tree["box_head"]["res5"][0]["branch2a_bn"]
        ref = jax.jit(jax_resnet.apply_roi_conv5_head)(jp["box_head"],
                                                       jnp.asarray(x, jd))
        got = port_resnet.apply_roi_conv5_head(params["box_head"], xt)
    _close(got, ref, tol)


IM_INFO = np.array([[250.0, 310.0, 1.0], [200.0, 300.0, 1.0]], np.float32)


def test_gn_detect_graph_matches_jax():
    tree = _init_model(0)
    jax_plain_paths()
    tree = calibrate_detector_params(_sorted(tree),
                                     np.random.RandomState(0))
    # GN keeps the features at unit scale, so the class logits barely move
    # from their biases: spread them.
    tree["box_outs"]["cls_score"]["w"] *= 100.0
    images = np.random.RandomState(0).randn(2, 256, 320, 3).astype(
        np.float32) * 20.0
    ref = jax.jit(lambda p, x, i: jax_test.detect_graph(p, x, i))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(images),
        jnp.asarray(IM_INFO))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = port_test.detect_graph(bridge.to_torch(tree, "cpu"),
                                 torch.from_numpy(images),
                                 torch.from_numpy(IM_INFO))
    assert set(got) == set(ref) and "mask_probs" in got
    assert ref["valid"].sum() > 4
    _assert_detections_match(got, ref, mask_atol=1e-4)


def _gn_paths(tree):
    return [p for p, _ in port_opt.flatten(tree)
            if port_opt.param_kind(p) == "gn"]


@pytest.fixture(scope="module")
def gn_step():
    """One JAX train step of the tiny GN Mask R-CNN (FREEZE_AT 0, a
    WEIGHT_DECAY_GN of its own), jitted once."""
    keys = TRAIN_KEYS + GN_KEYS + ["SOLVER.WEIGHT_DECAY_GN", "0.003"]
    set_cfgs(extra=keys)
    jax_plain_paths()
    tree = _sorted(port_init.init_model(0))
    batch = _batch(True)
    key = jax.random.PRNGKey(1)
    jp = jax.tree.map(jnp.asarray, tree)
    out = jax.jit(_jax_step)(jp, jax_opt.init_opt_state(jp),
                             jax.tree.map(jnp.asarray, batch), key)
    n_anchors, n_rois = port_tg.draw_sizes((64, 64), 8)
    return dict(keys=keys, tree=tree, ref=out,
                batch={k: torch.from_numpy(v) for k, v in batch.items()},
                draws=_replay_draws(key, n_anchors, n_rois))


def _port_run(c, dtype, masks=None):
    """The port's loss_and_grads on gn_step's inputs with params and
    compute in `dtype`: (total, parts, gradients as a {path: JAX-layout
    array} dict, every layers.relu input as float64). With `masks`, relu
    call i keeps masks[i] (x * mask) instead of x > 0."""
    port_cfg.TPU.COMPUTE_DTYPE = dtype
    inputs = []

    def relu(x):
        inputs.append(x.detach().double())
        if masks is None:
            return torch.relu(x)
        return x * masks[len(inputs) - 1].to(x.dtype)

    params = bridge.to_torch(c["tree"], "cpu", getattr(torch, dtype))
    plain, port_layers.relu = port_layers.relu, relu
    try:
        total, parts, grads = port_ts.loss_and_grads(params, c["batch"],
                                                     c["draws"])
    finally:
        port_layers.relu = plain
    return total, parts, dict(port_opt.flatten(
        bridge.to_jax_layout(grads))), inputs


def test_gn_train_step_matches_jax(gn_step):
    """Losses of the float32 step to rtol 1e-4; gradients of the port's
    float64 step within 1e-3 of each leaf's max|g| of JAX's float32 ones,
    and its SGD step's params within 1e-5; the float32 step's gradients
    within 1e-4 of a float64 step run with the float32 step's ReLU signs.
    GN puts many ReLU inputs near 0, and one within float32 rounding of it
    takes the other sign in the port's float32 step than in JAX's (ROADMAP
    Queue C's sign trap), which moves a gradient by a whole term (2e-3 of
    max|g| at these sizes): each such flip must be at an input within
    1e-4 of its call's max|x|."""
    c = gn_step
    set_cfgs(extra=c["keys"])
    total, parts, grads, new_params, lr = c["ref"]
    t32, parts32, g32, relu32 = _port_run(c, "float32")
    assert set(parts32) == set(parts) and "loss_mask" in parts
    for k, v in parts.items():
        np.testing.assert_allclose(float(parts32[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(t32), float(total), rtol=1e-4)
    _, _, g64, relu64 = _port_run(c, "float64")
    paths = [p for p, _ in port_opt.flatten(c["tree"])]
    _close_tree(port_opt.unflatten_like(c["tree"], iter(
        [g64[p] for p in paths])), grads, 1e-3, "grad")
    _, _, g64m, _ = _port_run(c, "float64", [x > 0 for x in relu32])
    for p in paths:
        top = np.abs(g64m[p]).max()
        assert np.abs(g32[p] - g64m[p]).max() <= 1e-4 * top + 1e-9, p
    for x32, x64 in zip(relu32, relu64):
        flip = (x32 > 0) != (x64 > 0)
        if bool(flip.any()):
            assert float(x64[flip].abs().max()) <= 1e-4 * float(
                x64.abs().max())
    port_cfg.TPU.COMPUTE_DTYPE = "float64"
    params = bridge.to_torch(c["tree"], "cpu", torch.float64)
    new_p, _, stats = port_ts.train_step(
        params, port_opt.init_opt_state(params), c["batch"], c["draws"])
    _close_tree(bridge.to_jax_layout(new_p), new_params, 1e-5, "params")
    np.testing.assert_allclose(float(stats["lr"]), float(lr), rtol=1e-7)


def test_gn_params_train_with_their_weight_decay(gn_step):
    """No stage is frozen (FREEZE_AT 0): every GN param, the stem's
    included, gets a nonzero gradient (but the posthoc GNs of P3-P5: no
    RPN anchor of those levels lies inside a 64 x 64 image, and every RoI
    pools from P2), and its first SGD step is lr (g + WEIGHT_DECAY_GN p),
    not the weights' WEIGHT_DECAY."""
    c = gn_step
    set_cfgs(extra=c["keys"])
    params = bridge.to_torch(c["tree"], "cpu")
    gn = _gn_paths(params)
    heads = {p[0] for p in gn}
    assert heads == {"body", "fpn", "box_head", "mask_head"}
    assert ("body", "res_conv1_bn", "s") in gn and \
        ("box_head", "gns", 1, "b") in gn
    _, _, grads = port_ts.loss_and_grads(params, c["batch"], c["draws"])
    new_p, _, lr = port_opt.apply_updates(
        params, grads, port_opt.init_opt_state(params))
    lr = float(lr)
    g, p0, p1 = (dict(port_opt.flatten(t)) for t in (grads, params, new_p))
    wd = port_cfg.SOLVER.WEIGHT_DECAY_GN
    assert wd != port_cfg.SOLVER.WEIGHT_DECAY
    idle = {("fpn", "fpn_res{}_gn".format(lvl)) for lvl in (3, 4, 5)}
    for path in gn:
        assert (float(g[path].abs().max()) > 0) != (path[:2] in idle), path
        want = p0[path] - lr * (g[path] + wd * p0[path])
        torch.testing.assert_close(p1[path], want, rtol=1e-6, atol=1e-9)


def test_gn_weights_round_trip_and_the_jax_table(tmp_path):
    """The port writes and reads Detectron's ConvGN names exactly. The JAX
    package's table names the GN body's blobs *_bn_*, the GN mask head's
    convs _[mask]_fcn*, and maps conv biases that ConvGN does not make:
    it cannot load the file (ROADMAP Queue C)."""
    tree = _init_model(0)
    blobs = dwh.to_detectron_blobs(tree)
    for name in ("conv1_gn_s", "res2_0_branch2a_gn_s", "res2_0_branch1_gn_b",
                 "fpn_inner_res5_2_sum_gn_s",
                 "fpn_inner_res4_5_sum_lateral_gn_b", "fpn_res2_2_sum_gn_s",
                 "head_conv1_gn_s", "_mask_fcn1_w", "_mask_fcn4_gn_b"):
        assert name in blobs, name
    assert not any(k.endswith("_bn_s") for k in blobs)
    assert "head_conv1_b" not in blobs and "fpn_res2_2_sum_b" not in blobs
    pkl = str(tmp_path / "gn.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"blobs": blobs}, f, pickle.HIGHEST_PROTOCOL)
    back = dict(port_opt.flatten(dwh.load_detectron_weight(
        _init_model(1), pkl)))
    for p, a in port_opt.flatten(tree):
        np.testing.assert_array_equal(back[p], a, err_msg=str(p))
    jax_names = set(jax_dwh.full_weight_mapping())
    assert "res2_0_branch2a_bn_s" in jax_names
    assert not {"conv1_gn_s", "res2_0_branch2a_gn_s",
                "_mask_fcn1_w"} & jax_names
    with pytest.raises(KeyError):
        jax_dwh.load_detectron_weight(_sorted(_init_model(1)), pkl)


def test_imagenet_weights_of_a_gn_body(tmp_path):
    """A Detectron-format R-50-GN.pkl (body blobs, conv1_gn_* and
    *_gn_*) fills the GN body exactly; a caffe .pth, which holds BN
    statistics, raises."""
    tree = _init_model(0)
    names = dwh.body_weight_mapping(50, 4)
    assert "conv1_gn_s" in names and "res5_2_branch2c_gn_b" in names
    pkl = str(tmp_path / "R-50-GN.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"blobs": {k: v for k, v in dwh.to_detectron_blobs(
            tree).items() if k in names}}, f, pickle.HIGHEST_PROTOCOL)
    got = dict(port_opt.flatten(rwh.load_pretrained_imagenet_weights(
        _init_model(1), pkl)))
    for p, a in port_opt.flatten(tree["body"], ("body",)):
        np.testing.assert_array_equal(got[p], a, err_msg=str(p))
    pth = str(tmp_path / "resnet50_caffe.pth")
    torch.save({}, pth)
    with pytest.raises(ValueError, match="GroupNorm"):
        rwh.load_pretrained_imagenet_weights(_init_model(1), pth)
