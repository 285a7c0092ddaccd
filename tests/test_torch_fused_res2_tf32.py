"""K6's float32 route (csrc/fused_res2.cu) on the CPU: the 3xTF32
arithmetic and the weight packing that ops/cuda/fused_stem_kernel.py hands
the kernel. The kernel itself runs only on the card
(tests/test_torch_cuda_kernels.py holds it to fused_res2_plain).

- split_tf32 gives a TF32 head (the low 13 bits zero) and a TF32 tail
  whose sum is the float32 value within 2^-22 of it: the tail's own
  rounding (half a TF32 ulp of a value below half a TF32 ulp of w).
- A conv summed as lo(a) hi(w) + hi(a) lo(w) + hi(a) hi(w) of the split
  operands (float64 sums, float32 out) is within 1e-5 of max|ref| of the
  float64 conv, alone and through the whole stage (every conv of
  fused_res2_plain so computed, against the plain stage in float64), and
  the stage of single TF32 products is not: the limit that the card tests
  hold the kernel to tells the two apart.
- pack_res2_weights_tf32's 104 chunks, read back in the kernel's order,
  give fold_res2_weights' convs: heads equal to split_tf32's, head + tail
  within 2^-22 of each weight.
"""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from detectron_tpu_torch.ops.cuda import fused_stem_kernel as fk
from test_torch_cuda_kernels import res2_stage

TOL = 1e-5


@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e4])
def test_split_tf32_reconstructs_float32(scale):
    w = torch.tensor(np.random.RandomState(0).randn(4096) * scale,
                     dtype=torch.float32)
    head, tail = fk.split_tf32(w)
    for part in (head, tail):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert bool(((head - w).abs() <= 2.0 ** -11 * w.abs()).all())
    err = (head.double() + tail.double() - w.double()).abs()
    assert bool((err <= 2.0 ** -22 * w.double().abs()).all())


def _conv_3xtf32(x, w, pad, products=3):
    """conv2d of NCHW x and OIHW w as the kernel multiplies them: both
    split by split_tf32, lo(x) hi(w) + hi(x) lo(w) + hi(x) hi(w) summed in
    float64 (products=1: hi(x) hi(w) alone), returned in float32."""
    xh, xl = fk.split_tf32(x.float())
    wh, wl = fk.split_tf32(w.float())

    def conv(a, b):
        return F.conv2d(a.double(), b.double(), None, 1, pad)
    out = conv(xh, wh)
    if products == 3:
        out = out + conv(xl, wh) + conv(xh, wl)
    return out.float()


@pytest.mark.parametrize("cin,k", [(64, 1), (64, 3), (256, 1)])
def test_3xtf32_conv_matches_float64(cin, k):
    rng = np.random.RandomState(cin + k)
    x = torch.tensor(rng.randn(1, cin, 6, 10), dtype=torch.float32).relu()
    w = torch.tensor(rng.randn(64, cin, k, k) / np.sqrt(cin * k * k),
                     dtype=torch.float32)
    ref = F.conv2d(x.double(), w.double(), None, 1, k // 2)
    got = _conv_3xtf32(x, w, k // 2)
    assert float((got.double() - ref).abs().max()) <= \
        TOL * float(ref.abs().max())


def _stage_3xtf32(monkeypatch, x, folded, products):
    """fused_res2_plain with every conv multiplied as _conv_3xtf32."""
    fake = types.SimpleNamespace(conv2d=lambda h, w, b, s, pad: _conv_3xtf32(
        h, w, pad, products))
    with monkeypatch.context() as m:
        m.setattr(fk, "F", fake)
        return fk.fused_res2_plain(x, folded)


@pytest.mark.parametrize("shape", [(1, 8, 16, 64), (2, 9, 17, 64)])
def test_3xtf32_stage_within_the_card_limit(monkeypatch, shape):
    folded = fk.fold_res2_weights(res2_stage(shape[1], "cpu"), torch.float32)
    x = torch.tensor(np.random.RandomState(shape[2]).randn(*shape),
                     dtype=torch.float32).relu()
    ref = fk.fused_res2_plain(
        x.double(), [{k: t.double() for k, t in blk.items()}
                     for blk in folded])
    limit = TOL * float(ref.abs().max())
    got = _stage_3xtf32(monkeypatch, x, folded, 3)
    assert float((got.double() - ref).abs().max()) <= limit
    one = _stage_3xtf32(monkeypatch, x, folded, 1)
    assert float((one.double() - ref).abs().max()) > limit


def _unpack(packed):
    """The packed chunks back to (Cout, K) float64 heads and head + tail per
    conv and block, read in the kernel's order (csrc/fused_res2.cu): 104
    chunks of 64 rows x 4 k-steps x 4 lanes x (head 2t, head 2t + 1, tail
    2t, tail 2t + 1)."""
    chunks = packed.reshape(104, 64, 4, 4, 4)
    heads = chunks[..., :2].reshape(104, 64, 32).double()
    sums = heads + chunks[..., 2:].reshape(104, 64, 32).double()
    blocks, c = [], 0

    def take(n):
        nonlocal c
        got = (torch.cat(list(heads[c:c + n]), 1),
               torch.cat(list(sums[c:c + n]), 1))
        c += n
        return got
    for i in range(3):
        blk = {"wa": take(2 if i == 0 else 8), "wb": take(18)}
        cs, ss = [], []
        for _ in range(4):
            cs.append(take(2))
            if i == 0:
                ss.append(take(2))
        blk["wc"] = tuple(torch.cat([p[j] for p in cs]) for j in range(2))
        if i == 0:
            blk["ws"] = tuple(torch.cat([p[j] for p in ss])
                              for j in range(2))
        blocks.append(blk)
    assert c == 104
    return blocks


def test_packed_chunks_unpack_to_the_fold():
    folded = fk.fold_res2_weights(res2_stage(3, "cpu"), torch.float32)
    packed, bias = fk.pack_res2_weights_tf32(folded)
    assert packed.dtype == torch.float32 and packed.shape == (104 * 4096,)
    assert torch.equal(bias, fk.pack_res2_weights(folded)[1])
    for blk, got in zip(folded, _unpack(packed)):
        assert set(got) == {k for k in blk if k[0] == "w"}
        for k, (head, total) in got.items():
            w = blk[k].permute(0, 2, 3, 1).reshape(blk[k].shape[0], -1)
            assert torch.equal(head, fk.split_tf32(w)[0].double())
            assert bool(((total - w.double()).abs()
                         <= 2.0 ** -22 * w.double().abs()).all())
