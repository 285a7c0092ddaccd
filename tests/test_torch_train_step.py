"""The port's training step against the JAX package's, on the tiny training
configuration (test_torch_util.TRAIN_KEYS: 2 images of 64 x 64, the JAX
suite's own _tiny_batch size, 4 classes, 32 RoIs and 32 anchors per image,
RPN 64 -> 16 proposals), with MASK_ON off and on, in float32. At larger
canvases (96 x 96 to 128 x 128) the JAX package's own float32 backward on
XLA:CPU drifts from its float64 result in the first blocks of res3 past
the 1e-3 bound below, while the port's float32 gradient stays with
float64; at 64 x 64 both agree with float64 well inside it.

Both packages get the same params (JAX init, carried over by the bridge),
the same batch and the same sampling uniforms: the test replays JAX's key
splits (train_graph.py:63-104, targets.py:97-105, :157-163) into the
port's `draws`. Checked:
- every loss and accuracy_cls of training_losses, to rtol 1e-4;
- the gradient of every leaf, brought back to the JAX layout with
  bridge.to_jax_layout: max|diff| <= 1e-3 max|g_jax| + 1e-6 (frozen and
  AffineChannel leaves are zero in both);
- the params after one train_step, to 1e-5 relative (of each leaf's
  largest value);
- that the port's iter_size accumulation is the mean-gradient step;
- and that utils/synthetic.synthetic_train_batch is the JAX batch.
The JAX side is jitted once per configuration (a trace reads the global
cfg), with the Pallas RoIAlign in interpret mode, as its own tests run it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.models import model_builder as jax_mb
from detectron_tpu.models import train_graph as jax_tg
from detectron_tpu.parallel import optimizer as jax_opt
from detectron_tpu.utils import synthetic as jax_synthetic
from detectron_tpu_torch.models import bridge
from detectron_tpu_torch.models import train_graph as port_tg
from detectron_tpu_torch.parallel import optimizer as port_opt
from detectron_tpu_torch.parallel import train_step as port_ts
from detectron_tpu_torch.utils import synthetic as port_synthetic
from test_torch_util import TRAIN_KEYS, set_cfgs

torch.set_num_threads(4)

B, H, W, G = 2, 64, 64, 8


def _batch(mask_on):
    rng = np.random.RandomState(0)
    gt = np.zeros((B, G, 4), np.float32)
    gt[:, 0] = [6, 8, 50, 44]
    gt[:, 1] = [30, 24, 60, 60]
    gt[1, 2] = [40, 4, 62, 30]
    gv = np.zeros((B, G), bool)
    gv[:, :2] = True
    gv[1, 2] = True
    gc = np.zeros((B, G), np.int32)
    gc[:, :3] = [[1, 3, 2], [2, 1, 3]]
    batch = {"images": rng.randn(B, H, W, 3).astype(np.float32),
             "im_info": np.array([[H, W, 1.0], [H - 8, W - 12, 1.0]],
                                 np.float32),
             "gt_boxes": gt, "gt_classes": gc, "gt_valid": gv,
             "crowd_boxes": np.zeros((B, 2, 4), np.float32),
             "crowd_valid": np.zeros((B, 2), bool)}
    if mask_on:
        # Edges on even cells: a RoI equal to its gt box (gt boxes are
        # sampled as RoIs) samples the 28-cell mask midway between cells 2j
        # and 2j + 1, where an edge gives exactly 0.5, a target that the
        # jitted JAX step rounds either way (against JAX's own eager one).
        masks = np.zeros((B, G, 28, 28), np.float32)
        masks[:, :, 4:22, 2:20] = 1.0
        masks[1, :, 10:, :8] = 1.0
        batch["gt_masks"] = masks
    return batch


def _replay_draws(key, n_anchors, n_rois):
    """JAX's in-graph uniforms of training_losses(..., key) as the port's
    draws."""
    rngs = jax.random.split(key, B + 2)
    roi_rngs = jax.random.split(rngs[B], B)
    out = {}
    for prefix, keys, n in (("rpn", rngs[:B], n_anchors),
                            ("roi", roi_rngs, n_rois)):
        pairs = [jax.random.split(k) for k in keys]
        out[prefix + "_fg"] = np.stack(
            [np.asarray(jax.random.uniform(k1, (n,))) for k1, _ in pairs])
        out[prefix + "_bg"] = np.stack(
            [np.asarray(jax.random.uniform(k2, (n,))) for _, k2 in pairs])
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _jax_step(params, opt_state, batch, key):
    def loss_fn(p):
        return jax_tg.training_losses(p, batch, key)

    (total, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    new_params, new_opt_state, lr = jax_opt.apply_updates(params, grads,
                                                          opt_state)
    return total, parts, grads, new_params, lr


def _leaves(tree):
    return [x for _, x in port_opt.flatten(tree)]


def _close_tree(got, ref, rel, what):
    for (path, g), r in zip(port_opt.flatten(got), _leaves(ref)):
        r = np.asarray(r)
        assert g.shape == r.shape, (what, path)
        bound = rel * np.abs(r).max() + 1e-6
        err = np.abs(g - r).max()
        assert err <= bound, (what, path, err, bound)


@pytest.fixture(scope="module", params=[False, True], ids=["box", "mask"])
def case(request):
    mask_on = request.param
    set_cfgs(mask_on=mask_on, extra=TRAIN_KEYS)
    tree = jax.tree.map(np.asarray, jax_mb.init_model(jax.random.PRNGKey(0)))
    batch = _batch(mask_on)
    key = jax.random.PRNGKey(1)
    jp = jax.tree.map(jnp.asarray, tree)
    ref = jax.jit(_jax_step)(jp, jax_opt.init_opt_state(jp),
                             jax.tree.map(jnp.asarray, batch), key)
    n_anchors, n_rois = port_tg.draw_sizes((H, W), G)
    return dict(mask_on=mask_on, tree=tree, key=key, ref=ref,
                batch={k: torch.from_numpy(v) for k, v in batch.items()},
                draws=_replay_draws(key, n_anchors, n_rois))


def test_losses_and_gradients_match_jax(case):
    set_cfgs(mask_on=case["mask_on"], extra=TRAIN_KEYS)
    total, parts, grads, _, _ = case["ref"]
    params = bridge.to_torch(case["tree"], "cpu")
    got_total, got_parts, got_grads = port_ts.loss_and_grads(
        params, case["batch"], case["draws"])
    assert set(got_parts) == set(parts)
    assert ("loss_mask" in parts) == case["mask_on"]
    for k, v in parts.items():
        np.testing.assert_allclose(float(got_parts[k]), float(v), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(got_total), float(total), rtol=1e-4)
    assert float(parts["loss_cls"]) > 0 and float(parts["loss_bbox"]) > 0
    _close_tree(bridge.to_jax_layout(got_grads), grads, 1e-3, "grad")
    # The frozen stem, res2 and every AffineChannel get no gradient.
    for path, g in port_opt.flatten(got_grads):
        if port_opt.param_kind(path) in port_opt.FROZEN_KINDS:
            assert not bool(g.any()), path


def test_train_step_params_match_jax(case):
    set_cfgs(mask_on=case["mask_on"], extra=TRAIN_KEYS)
    _, parts, _, new_params, lr = case["ref"]
    params = bridge.to_torch(case["tree"], "cpu")
    new_p, new_o, stats = port_ts.train_step(
        params, port_opt.init_opt_state(params), case["batch"],
        case["draws"])
    assert new_o["step"] == 1
    np.testing.assert_allclose(float(stats["lr"]), float(lr), rtol=1e-7)
    np.testing.assert_allclose(float(stats["loss_cls"]),
                               float(parts["loss_cls"]), rtol=1e-4)
    _close_tree(bridge.to_jax_layout(new_p), new_params, 1e-5, "params")
    moved = sum(not torch.equal(a, b) for a, b in
                zip(_leaves(params), _leaves(new_p)))
    assert moved > 0


def test_draw_sizes_match_the_step():
    set_cfgs(mask_on=False, extra=TRAIN_KEYS)
    draws = port_tg.make_draws(torch.Generator().manual_seed(0), B, (H, W),
                               G, "cpu")
    assert draws["rpn_fg"].shape == (B, 3 * (16 * 16 + 8 * 8 + 4 * 4
                                             + 2 * 2 + 1 * 1))
    assert draws["roi_fg"].shape == (B, 16 + G)
    bad = dict(draws, roi_bg=draws["roi_bg"][:, :-1])
    params = bridge.to_torch(jax.tree.map(
        np.asarray, jax_mb.init_model(jax.random.PRNGKey(0))), "cpu")
    with pytest.raises(ValueError, match="roi_bg"):
        port_tg.training_losses(params, {
            k: torch.from_numpy(v) for k, v in _batch(False).items()}, bad)


def test_iter_size_accumulation_is_the_mean_gradient_step():
    """train_step_accum over two microbatches (images + 0 and + 0.5) makes
    the update of the mean of their gradients, the contract the JAX
    suite proves for make_pjit_train_step_accum
    (tests/test_train_step.py::test_grad_accumulation_equivalent_...)."""
    set_cfgs(mask_on=False, extra=TRAIN_KEYS)
    params = bridge.to_torch(jax.tree.map(
        np.asarray, jax_mb.init_model(jax.random.PRNGKey(0))), "cpu")
    b0 = {k: torch.from_numpy(v) for k, v in _batch(False).items()}
    b1 = dict(b0, images=b0["images"] + 0.5)
    gen = torch.Generator().manual_seed(5)
    draws = [port_tg.make_draws(gen, B, (H, W), G, "cpu") for _ in range(2)]
    grads = [port_ts.loss_and_grads(params, b, d)[2]
             for b, d in zip((b0, b1), draws)]
    mean = port_opt.unflatten_like(params, iter(
        [(g0 + g1) / 2.0 for g0, g1 in zip(_leaves(grads[0]),
                                           _leaves(grads[1]))]))
    ref_p, _, _ = port_opt.apply_updates(
        params, mean, port_opt.init_opt_state(params))
    new_p, new_o, stats = port_ts.train_step_accum(
        params, port_opt.init_opt_state(params), [b0, b1], draws)
    assert new_o["step"] == 1 and bool(torch.isfinite(stats["loss"]))
    for a, r in zip(_leaves(new_p), _leaves(ref_p)):
        torch.testing.assert_close(a, r, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("mask_on", [False, True])
def test_synthetic_train_batch_matches_jax(mask_on):
    set_cfgs(mask_on=mask_on, extra=TRAIN_KEYS)
    ref = jax_synthetic.synthetic_train_batch(3, 256, 320,
                                              np.random.RandomState(4))
    got = port_synthetic.synthetic_train_batch(3, 256, 320, "cpu",
                                               np.random.RandomState(4))
    assert set(got) == set(ref) and ("gt_masks" in got) == mask_on
    for k, v in ref.items():
        v = np.asarray(v)
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
