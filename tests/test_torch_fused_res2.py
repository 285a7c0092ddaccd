"""The PyTorch port's TPU.FUSED_RES2 path against the JAX package's: the
weight fold, the plain versions of K5 (stem_pool) and K6 (fused_res2)
against the Pallas kernels in interpret mode, and the body / features with
the path on, in each of its modes (packed, auto, ineligible).

Tolerances: float32 to 1e-5 of max|ref| (both accumulate in f32, in other
orders). bfloat16 stages to 2^-7 |ref| (one bf16 ulp of the value) plus
2^-6 max|ref| (2 to 4 ulps at the stage's top magnitude), with under 20%
of the elements differing: both versions round at the same points, but
where their f32 sums fall either side of a bf16 rounding boundary an
element moves by an ulp, later convs carry that on, and a residual add
that cancels (relu(c + h) with c ~ -h) keeps the ulps of its operands. A
systematic rounding fault would move about half the elements. K5's plain
version equals the Pallas kernel exactly. Whole bodies and features
through the port's other layers keep the tolerances of
tests/test_torch_backbone.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron_tpu.models import model_builder as jax_mb
from detectron_tpu.models import resnet as jax_resnet
from detectron_tpu.ops.pallas import fused_stem_kernel as jfk
from detectron_tpu_torch.models import bridge
from detectron_tpu_torch.models import model_builder as port_mb
from detectron_tpu_torch.models import resnet as port_resnet
from detectron_tpu_torch.ops.cuda import fused_stem_kernel as fk
from test_torch_util import set_cfgs

torch.set_num_threads(2)

FUSED = ["TPU.FUSED_RES2", "True"]


def _stage_tree(seed):
    """A JAX res2 stage with random affines (so the fold is not the
    identity), as numpy arrays."""
    params = jax_resnet.init_stage(jax.random.PRNGKey(seed), 3, 64, 256, 64)
    r = np.random.RandomState(seed)
    for bp in params:
        for k in list(bp):
            if k.endswith("_bn"):
                c = bp[k]["s"].shape[0]
                bp[k] = {"s": r.uniform(0.5, 1.5, c).astype(np.float32),
                         "b": r.uniform(-0.3, 0.3, c).astype(np.float32)}
    return jax.tree.map(np.asarray, params)


def _bridged_stage(tree, dtype):
    return bridge.to_torch({"body": {"res2": tree}}, "cpu",
                           dtype)["body"]["res2"]


def _unpack_jax_fold(ops):
    """fold_res2_weights' TPU operands (x-pair block-diagonal / packed 3x3
    taps) back to plain (HWIO / (Cin, Cout)) float32 arrays per block."""
    ops = [np.asarray(o, np.float32) for o in ops]
    blocks = []
    for i in range(3):
        wa, ba, wb, bb, wc, bc = ops[6 * i:6 * i + 6]
        cin = wa.shape[0] // 2
        # _pack_w3: block (p_in, p_out) of packed[dy][du + 1] is the tap
        # dx = 2 du + p_in - p_out; du = 0 holds all three.
        taps = [np.stack([wb[dy, 1][:64, 64:], wb[dy, 1][:64, :64],
                          wb[dy, 1][64:, :64]]) for dy in range(3)]
        blk = {"wa": wa[:cin, :64], "ba": ba[0, :64], "wb": np.stack(taps),
               "bb": bb[0, :64], "wc": wc[:64, :256], "bc": bc[0, :256]}
        if i == 0:
            blk["ws"] = wc[128:192, :256]
        blocks.append(blk)
    return blocks


def _plain_layout(blk):
    out = {}
    for k, t in blk.items():
        t = t.float().numpy()
        if k == "wb":
            t = t.transpose(2, 3, 1, 0)        # OIHW -> HWIO
        elif k[0] == "w":
            t = t[:, :, 0, 0].T                # (Cout, Cin, 1, 1) -> (Cin, Cout)
        out[k] = t
    return out


@pytest.mark.parametrize("bridge_dtype,fold_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
def test_fold_matches_jax(bridge_dtype, fold_dtype):
    """The port's fold equals fold_res2_weights' values exactly, also from
    a tree bridged in bf16 (the bridge keeps res2 in float32, so the fold
    multiplies float32 values, as JAX does)."""
    tree = _stage_tree(0)
    ref = _unpack_jax_fold(jfk.fold_res2_weights(
        jax.tree.map(jnp.asarray, tree), getattr(jnp, fold_dtype)))
    stage = _bridged_stage(tree, getattr(torch, bridge_dtype))
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(stage))
    got = fk.fold_res2_weights(stage, getattr(torch, fold_dtype))
    for i, (g, r) in enumerate(zip(got, ref)):
        assert set(g) == set(r)
        assert g["wa"].dtype == getattr(torch, fold_dtype)
        assert g["ba"].dtype == torch.float32
        for k, v in _plain_layout(g).items():
            np.testing.assert_array_equal(v, r[k], err_msg="{} {}".format(
                i, k))


def _assert_bf16_close(got, ref, scale=1, max_share=0.2):
    """|got - ref| <= scale (2^-7 |ref| + 2^-6 max|ref|); under max_share
    of the elements differ (None: no limit)."""
    d = np.abs(got - ref)
    bound = scale * (2.0 ** -7 * np.abs(ref) + 2.0 ** -6 * np.abs(ref).max())
    assert (d <= bound).all(), (d.max(), (d / bound).max())
    assert max_share is None or (d > 0).mean() < max_share, (d > 0).mean()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16, 32, 64), (1, 8, 16, 64)])
def test_fused_res2_plain_matches_jax(shape, dtype):
    """(1, 8, 16, 64) is one JAX tile: every halo row is an image edge."""
    tree = _stage_tree(1)
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jfk.fused_res2(jnp.asarray(x, jd), tuple(jfk.fold_res2_weights(
        jax.tree.map(jnp.asarray, tree), jd)), ty=8, interpret=True)
    ref = np.asarray(ref, np.float32)
    got = fk.fused_res2(torch.from_numpy(x).to(td), fk.fold_res2_weights(
        _bridged_stage(tree, td), td))
    assert got.dtype == td and tuple(got.shape) == shape[:3] + (256,)
    got = got.float().numpy()
    if dtype == "float32":
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    else:
        _assert_bf16_close(got, ref)


def test_stem_pool_plain_matches_jax():
    """K5's plain version equals stem_pool_pack exactly, once unpacked:
    (B, H, U, 2C) -> (B, H, U, 2, C) -> (B, H, W, C)."""
    r = np.random.RandomState(7)
    x = (r.randn(2, 32, 64, 64) * 2.0).astype(np.float32)
    s = r.uniform(0.5, 1.5, 64).astype(np.float32)
    b = r.uniform(-0.5, 0.5, 64).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jfk.stem_pool_pack(xj, jnp.asarray(s), jnp.asarray(b),
                                        typ=8, interpret=True), np.float32)
    B, H, U, C2 = ref.shape
    ref = ref.reshape(B, H, U, 2, C2 // 2).reshape(B, H, 2 * U, C2 // 2)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    got = fk.stem_pool(xt, torch.from_numpy(s), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.float().numpy(), ref)


def _spy(monkeypatch):
    """Count the port's calls of the two kernel wrappers."""
    calls = {"stem_pool": 0, "fused_res2": 0}
    for name in calls:
        fn = getattr(fk, name)

        def wrapped(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(fk, name, wrapped)
    return calls


@pytest.mark.parametrize("mode,dtype,hw", [
    ("packed", "bfloat16", (64, 64)), ("auto", "float32", (64, 64)),
    (None, "float32", (72, 64)), (None, "bfloat16", (72, 64))])
def test_apply_body_fused_matches_jax(monkeypatch, mode, dtype, hw):
    """apply_body (res2, res3) with TPU.FUSED_RES2 against JAX's, each mode
    by its gates: packed (bf16 on an eligible canvas), auto (f32) and
    ineligible (72 x 64: 18 post-pool rows fit no tile), which equals
    FUSED_RES2 False bit for bit."""
    set_cfgs(extra=FUSED)
    tree = jax.tree.map(np.asarray, jax_resnet.init_body(
        jax.random.PRNGKey(4), 50, 2))
    x = np.random.RandomState(5).randn(1, *hw, 3).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    with jfk.force_interpret():
        ref = jax_resnet.apply_body(jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(x, jd), num_stages=2)
    p = bridge.to_torch({"body": tree}, "cpu", td)["body"]
    calls = _spy(monkeypatch)
    got = port_resnet.apply_body(p, torch.from_numpy(x).to(td), 2)
    assert calls == {"stem_pool": int(mode == "packed"),
                     "fused_res2": int(mode is not None)}
    for lvl, (g, r) in enumerate(zip(got, ref)):
        g, r = g.float().numpy(), np.asarray(r, np.float32)
        assert g.shape == r.shape
        err = np.abs(g - r).max() / np.abs(r).max()
        if dtype == "float32":
            assert err <= 1e-5, (lvl, err)
        elif lvl == 0:
            # The stem conv before the stage rounds its bf16 output
            # differently in the two frameworks (an ulp here and there),
            # and the stage carries that on: twice the bound, no limit on
            # the share.
            _assert_bf16_close(g, r, scale=2, max_share=None)
        else:
            assert err < 5e-2, (lvl, err)
    if mode is None:
        set_cfgs()
        off = port_resnet.apply_body(p, torch.from_numpy(x).to(td), 2)
        for a, b in zip(got, off):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-2)])
def test_forward_features_fused_matches_jax(monkeypatch, dtype, tol):
    """forward_features (body + FPN) with TPU.FUSED_RES2 on the tiny
    configuration's 256 x 320 canvas: packed in bf16, auto in f32."""
    set_cfgs(extra=FUSED + ["TPU.COMPUTE_DTYPE", dtype])
    tree = jax_mb.init_model(jax.random.PRNGKey(0))
    images = np.random.RandomState(0).randn(2, 256, 320, 3).astype(
        np.float32) * 20.0
    with jfk.force_interpret():
        # A fresh function: jit traces read the cfg and the interpret flag.
        ref, _ = jax.jit(lambda p, x: jax_mb.forward_features(p, x))(
            tree, jnp.asarray(images))
    params = bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu",
                             getattr(torch, dtype))
    calls = _spy(monkeypatch)
    with torch.no_grad():
        got, _ = port_mb.forward_features(params, torch.from_numpy(images))
    assert calls == {"stem_pool": int(dtype == "bfloat16"), "fused_res2": 1}
    for lvl, (g, r) in enumerate(zip(got, ref), start=2):
        r = np.asarray(jnp.asarray(r, jnp.float32))
        assert tuple(g.shape) == r.shape
        err = np.abs(g.float().numpy() - r).max() / np.abs(r).max()
        assert err < tol, (lvl, err)


def test_res3_grads_through_fused_body_match_jax():
    """FREEZE_AT 2: no gradient reaches the fused stage, and res3's
    gradients through the fused body match JAX's (64 x 64, float32; the
    squared loss amplifies the forward's f32 differences, so 1e-4 of each
    leaf's max|g|, as tests/test_fused_res2.py allows)."""
    set_cfgs(extra=FUSED)
    tree = jax.tree.map(np.asarray, jax_resnet.init_body(
        jax.random.PRNGKey(8), 50, 2))
    x = np.random.RandomState(9).randn(1, 64, 64, 3).astype(np.float32)

    def loss(p):
        outs = jax_resnet.apply_body(p, jnp.asarray(x), num_stages=2,
                                     freeze_at=2)
        return jnp.sum(outs[-1].astype(jnp.float32) ** 2)

    with jfk.force_interpret():
        ref = jax.grad(loss)(jax.tree.map(jnp.asarray, tree))["res3"]
    p = bridge.to_torch({"body": tree}, "cpu")["body"]
    leaves = [t.requires_grad_(True) for t in jax.tree.leaves(p["res3"])]
    outs = port_resnet.apply_body(p, torch.from_numpy(x), 2)
    assert not outs[0].requires_grad
    # The frozen AffineChannel leaves get no gradient (JAX's are zeros).
    grads = torch.autograd.grad((outs[-1] ** 2).sum(), leaves,
                                allow_unused=True)
    got = bridge.to_jax_layout(jax.tree.unflatten(
        jax.tree.structure(p["res3"]),
        [torch.zeros_like(t) if g is None else g
         for t, g in zip(leaves, grads)]))
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        r = np.asarray(r)
        assert g.shape == r.shape
        scale = np.abs(r).max() + 1e-6
        assert np.abs(g - r).max() / scale < 1e-4
