"""The port's SGD (parallel/optimizer.py) against the JAX package's
apply_updates on a small tree with Caffe2 keys: a warm-up step, a STEPS
decay boundary (the momentum correction), global-norm gradient clipping,
2x bias LR, weight decay, FREEZE_AT and FREEZE_CONV_BODY. New params,
momentum and lr agree to 1e-6 relative; AffineChannel and frozen leaves are
returned unchanged, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.parallel import optimizer as jax_opt
from detectron_tpu_torch.parallel import optimizer as port_opt
from test_torch_util import TRAIN_KEYS, set_cfgs


def _tree(rng):
    def a(*shape):
        return rng.randn(*shape).astype(np.float32)

    def block(c):
        return {"branch2a": {"w": a(1, 1, c, c)},
                "branch2a_bn": {"s": a(c), "b": a(c)}}

    return {
        "body": {"conv1": {"w": a(7, 7, 3, 4)},
                 "res_conv1_bn": {"s": a(4), "b": a(4)},
                 "res2": [block(4), block(4)], "res3": [block(8)],
                 "res4": [block(8)]},
        "fpn": {"fpn_inner_res2": {"w": a(1, 1, 4, 8), "b": a(8)}},
        "rpn": {"conv_rpn": {"w": a(3, 3, 8, 8), "b": a(8)}},
        "box_head": {"fc6": {"w": a(16, 8), "b": a(8)}},
        "box_outs": {"cls_score": {"w": a(8, 4), "b": a(4)}},
    }


CASES = {
    "warm_up": (0, []),
    "after_warm_up": (50, []),
    "decay_boundary": (100, []),
    "clip": (3, ["SOLVER.CLIP_GRADIENTS", "0.5"]),
    "bias_wd_no_double_lr": (60, ["SOLVER.BIAS_WEIGHT_DECAY", "True",
                                  "SOLVER.BIAS_DOUBLE_LR", "False"]),
    "freeze_at_3": (7, ["RESNETS.FREEZE_AT", "3"]),
    "freeze_conv_body": (7, ["TRAIN.FREEZE_CONV_BODY", "True"]),
    "step_policy_constant_warm_up": (
        1, ["SOLVER.LR_POLICY", "step", "SOLVER.STEP_SIZE", "1",
            "SOLVER.WARM_UP_METHOD", "constant"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_updates_matches_jax(case):
    step, extra = CASES[case]
    set_cfgs(extra=TRAIN_KEYS + ["SOLVER.WEIGHT_DECAY", "0.01"] + extra)
    rng = np.random.RandomState(len(case))
    params = _tree(rng)
    grads = jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32),
                         params)
    mom = jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32),
                       params)

    ref_p, ref_o, ref_lr = jax.jit(
        lambda p, g, o: jax_opt.apply_updates(p, g, o))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        {"momentum": jax.tree.map(jnp.asarray, mom),
         "step": jnp.int32(step)})

    t = lambda tree: jax.tree.map(torch.from_numpy, tree)  # noqa: E731
    tp = t(params)
    got_p, got_o, got_lr = port_opt.apply_updates(
        tp, t(grads), {"momentum": t(mom), "step": step})
    assert got_o["step"] == int(ref_o["step"]) == step + 1
    np.testing.assert_allclose(float(got_lr), float(ref_lr), rtol=1e-7)

    n_frozen = 0
    for (path, g), (_, r), (_, rv), (_, gv), (_, p0) in zip(
            port_opt.flatten(got_p), port_opt.flatten(ref_p),
            port_opt.flatten(ref_o["momentum"]),
            port_opt.flatten(got_o["momentum"]), port_opt.flatten(tp)):
        if port_opt.param_kind(path) in port_opt.FROZEN_KINDS:
            assert g is p0, path
            n_frozen += 1
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(r)).max(),
                                   err_msg=str(path))
        np.testing.assert_allclose(gv.numpy(), np.asarray(rv), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(rv)).max(),
                                   err_msg=str(path))
    assert n_frozen >= 6
    if case == "freeze_conv_body":
        assert got_p["fpn"]["fpn_inner_res2"]["w"] is \
            tp["fpn"]["fpn_inner_res2"]["w"]


def test_param_kinds():
    set_cfgs(extra=TRAIN_KEYS)
    kinds = {path: port_opt.param_kind(path)
             for path, _ in port_opt.flatten(_tree(np.random.RandomState(0)))}
    assert kinds[("body", "conv1", "w")] == "frozen"
    assert kinds[("body", "res2", 1, "branch2a", "w")] == "frozen"
    assert kinds[("body", "res3", 0, "branch2a", "w")] == "weight"
    assert kinds[("body", "res3", 0, "branch2a_bn", "s")] == "affine"
    assert kinds[("fpn", "fpn_inner_res2", "b")] == "bias"
    assert kinds[("box_head", "fc6", "w")] == "weight"
