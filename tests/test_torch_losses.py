"""Losses of the PyTorch port (models/losses.py) against the JAX package's
(detectron_tpu/models/losses.py), in float32 to rtol 1e-5: the RPN losses
with ignored (-1) anchors, the Fast R-CNN losses with class-specific and
class-agnostic regression and with no fg RoI at all, and the mask loss
with class-specific and class-agnostic logits. Gradients w.r.t. the logits
and predictions agree too (same tolerance), at logits of exactly 0 as
well (zero-padded canvas regions give many)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.models import losses as jax_L
from detectron_tpu_torch.models import losses as port_L
from test_torch_util import TRAIN_KEYS, set_cfgs

torch.set_num_threads(2)


def _check(jax_fn, port_fn, float_args, other_args):
    """Values and gradients w.r.t. the float args of both functions."""
    ref = jax_fn(*[jnp.asarray(a) for a in float_args],
                 *[jnp.asarray(a) for a in other_args])
    ref_g = jax.grad(lambda *f: sum(jax_fn(*f, *[jnp.asarray(a) for a in
                                                  other_args])[:2])
                     if isinstance(ref, tuple) else
                     jax_fn(*f, *[jnp.asarray(a) for a in other_args]),
                     argnums=tuple(range(len(float_args))))(
        *[jnp.asarray(a) for a in float_args])
    tf = [torch.tensor(a, requires_grad=True) for a in float_args]
    got = port_fn(*tf, *[torch.from_numpy(np.asarray(a)) for a in
                         other_args])
    loss = sum(got[:2]) if isinstance(got, tuple) else got
    got_g = torch.autograd.grad(loss, tf)
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        np.testing.assert_allclose(float(g.detach()), float(r), rtol=1e-5,
                                   atol=1e-7)
    for g, r in zip(got_g, ref_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-7 * max(1.0, np.abs(r).max()))
    return ref


def test_rpn_losses_match_jax():
    set_cfgs(extra=TRAIN_KEYS)
    rng = np.random.RandomState(0)
    N = 2 * 300
    logits = (rng.randn(N) * 3).astype(np.float32)
    logits[:5] = 0.0
    pred = rng.randn(N, 4).astype(np.float32) * 0.3
    labels = rng.choice([-1, -1, -1, 0, 1], N).astype(np.int32)
    targets = rng.randn(N, 4).astype(np.float32) * 0.2
    targets[labels != 1] = 0.0
    _check(jax_L.rpn_losses, port_L.rpn_losses, [logits, pred],
           [labels, targets, labels == 1])


@pytest.mark.parametrize("n_reg,no_fg", [(4, False), (2, False), (4, True)])
def test_fast_rcnn_losses_match_jax(n_reg, no_fg):
    set_cfgs(extra=TRAIN_KEYS)
    rng = np.random.RandomState(n_reg + no_fg)
    N, C = 64, 4
    logits = rng.randn(N, C).astype(np.float32) * 2
    pred = rng.randn(N, 4 * n_reg).astype(np.float32) * 0.5
    labels = rng.randint(0, C, N).astype(np.int32)
    if no_fg:
        labels[:] = 0
    valid = rng.rand(N) < 0.8
    labels[~valid] = 0
    fg = valid & (labels > 0)
    targets = rng.randn(N, 4).astype(np.float32)
    targets[~fg] = 0.0
    ref = _check(jax_L.fast_rcnn_losses, port_L.fast_rcnn_losses,
                 [logits, pred], [labels, valid, targets, fg])
    if no_fg:
        assert float(ref[1]) == 0.0


@pytest.mark.parametrize("n_cls", [4, 1])
def test_mask_losses_match_jax(n_cls):
    set_cfgs(extra=TRAIN_KEYS)
    rng = np.random.RandomState(n_cls)
    N, M = 16, 14
    logits = rng.randn(N, M, M, n_cls).astype(np.float32) * 3
    targets = (rng.rand(N, M, M) > 0.5).astype(np.float32)
    labels = rng.randint(1, 4, N).astype(np.int32)
    valid = rng.rand(N) < 0.6
    _check(jax_L.mask_rcnn_losses, port_L.mask_rcnn_losses, [logits],
           [targets, labels, valid])
