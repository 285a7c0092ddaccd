"""Exact two-stage chunked top-k (port of detectron_tpu/ops/topk.py ::
topk_chunked, topk.py:114-158).

The JAX version's index SET depends on lax.top_k's lowest-index-first tie
order inside each chunk and again in the merge (topk.py:123-130), and the
zero-padded canvas gives thousands of equal RPN logits. Each stage here is
a stable descending sort, which keeps equal values in index order, so the
chosen indices match JAX's exactly under ties (a bare torch.topk promises
no tie order).
"""

import math

import torch


def top_k(x, k):
    """lax.top_k over the last axis: (values, int64 indices), descending,
    lowest index first among equal values."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def topk_chunked(x, k):
    n = x.shape[-1]
    k = min(k, n)
    nchunks = max(1, round(n / int(math.sqrt(float(n) * k))))
    if nchunks <= 1 or n < 4 * k:
        return top_k(x, k)
    c = -(-n // nchunks)
    pad = nchunks * c - n
    lead = x.shape[:-1]
    xp = torch.nn.functional.pad(x, (0, pad), value=-math.inf) if pad else x
    kk = min(k, c)
    v1, i1 = top_k(xp.reshape(lead + (nchunks, c)), kk)
    base = torch.arange(nchunks, device=x.device)[:, None] * c
    flat_idx = torch.clamp((i1 + base).reshape(lead + (nchunks * kk,)),
                           max=n - 1)
    v2, i2 = top_k(v1.reshape(lead + (nchunks * kk,)), k)
    return v2, torch.gather(flat_idx, -1, i2)
