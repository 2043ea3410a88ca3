"""The algebra of ``csrc/decode_attn.cu``'s split, on the CPU: a torch model of
the kernel's arithmetic (written here, not in the package) held to
``decode_attention_plain`` and, through the same seeded numpy inputs, to
the JAX package's ``attend`` at T = 1.

The model deals chunks of C consecutive key positions to NC parts (part r
takes chunks r, r + NC, ...), takes each head's max over all parts, then
sums exp(s - M) part by part (a part's 32-lane partials over its chunks in
order, then a fixed xor tree over the lanes) and adds the NC sums in part
order; it normalises, scales (int8) and rounds the probabilities to bf16 on
the bf16 path before the value product, and adds the parts' partial outputs
in part order. Every step is elementwise in torch, so a row's bits cannot
depend on the batch, and a column past a row's position adds an exact 0,
so they cannot depend on kv_window either: both are checked bit for bit.

Tolerances as ``tests/test_torch_decode_attention.py``: f32 1e-5 (the sums'
order alone); bf16 atol 1.6e-2 + rtol 1e-2 (one bf16 step of the outputs,
the probabilities rounded to bf16 on both sides)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_decode_attention import ARMS, TOL, _case, _jax_attend, _port, _t

# csrc/decode_attn.cu's kNC (CTAs of a cluster) and kC (keys a chunk)
NC, C = 8, 32
MASKED = -1e30


def _lane_tree(x):
    """The sum over the last dim (32 lanes) by the xor butterfly."""
    lane = torch.arange(x.shape[-1])
    o = x.shape[-1] // 2
    while o:
        x = x + x[..., lane ^ o]
        o //= 2
    return x[..., 0]


def split_model(q, k, v, pos, *, scale, k_scale=None, v_scale=None, kv_valid=None,
                window=0, kv_window=None, nc=NC, c=C):
    """Decode attention of q [B, Hq, D] over contiguous k, v [B, S, Hkv, D]
    as the kernel splits it (see the module note); a row with no valid key
    comes out 0, as from the kernel."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    n_cols = kv_window or k.shape[1]
    bf16 = not (q.dtype == torch.float32 or k.dtype == torch.float32)
    nch = -(-n_cols // c)
    width = nch * c

    def cols(x):
        """The scanned columns, f32, zero-padded to whole chunks: [B, width, ...]."""
        x = x[:, :n_cols].float()
        return F.pad(x, (0, 0) * (x.ndim - 2) + (0, width - n_cols))
    kf, vf = cols(k).permute(0, 2, 1, 3), cols(v).permute(0, 2, 1, 3)  # [B, Hkv, W, D]
    qf = q.float().reshape(b, hkv, g, d)
    s = torch.zeros(b, hkv, g, width)
    for e in range(d):
        s = s + qf[..., e:e + 1] * kf[:, :, None, :, e]
    s = s * scale
    if k_scale is not None:
        s = s * cols(k_scale).permute(0, 2, 1)[:, :, None, :]
    p = torch.as_tensor(pos).long().reshape(-1).expand(b)[:, None]
    col = torch.arange(width)[None, :]
    mask = (col <= p) & (col < n_cols)
    if window:
        mask &= col > p - window
    if kv_valid is not None:
        mask &= F.pad(kv_valid[:, :n_cols], (0, width - n_cols))
    mask = mask[:, None, None, :]
    s = s.masked_fill(~mask, MASKED)

    parts = [range(r, nch, nc) for r in range(nc)]
    chunk = lambda x, ch: x[..., ch * c:(ch + 1) * c]  # noqa: E731
    m = s.amax(dim=-1, keepdim=True)                # max: the same in any order
    e = torch.where(mask, torch.exp(s - m), 0.0)
    total = torch.zeros(b, hkv, g)
    for r in range(nc):                             # the parts in order
        lanes = torch.zeros(b, hkv, g, c)
        for ch in parts[r]:
            lanes = lanes + chunk(e, ch)
        total = total + _lane_tree(lanes)
    probs = torch.where(mask, torch.exp(s - m) / total[..., None], 0.0)
    if v_scale is not None:
        probs = probs * cols(v_scale).permute(0, 2, 1)[:, :, None, :]
    if bf16:
        probs = probs.to(torch.bfloat16).float()
    out = torch.zeros(b, hkv, g, d)
    for r in range(nc):
        part = torch.zeros(b, hkv, g, d)
        for ch in parts[r]:
            for j in range(ch * c, (ch + 1) * c):
                part = part + probs[..., j:j + 1] * vf[:, :, None, j, :]
        out = out + part
    out = torch.where(mask.any(-1, keepdim=True), out, 0.0)
    return out.reshape(b, hq, d).to(q.dtype)


def _model(case, dtype, **kw):
    kv = (lambda x: _t(x, dtype)) if case["ks"] is None else _t
    opt = lambda x: None if x is None else _t(x)  # noqa: E731
    return split_model(
        _t(case["q"], dtype), kv(case["k"]), kv(case["v"]), _t(case["pos"]),
        scale=case["scale"], k_scale=opt(case["ks"]), v_scale=opt(case["vs"]),
        kv_valid=opt(case["valid"]), window=case["window"], **kw)


@pytest.mark.parametrize("nc,c", [(NC, C), (2, 8)], ids=["kernel", "two-parts-of-8"])
@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("window,valid", [(0, False), (24, False), (0, True)],
                         ids=["causal", "window", "kv_valid"])
def test_split_matches_plain_and_jax_attend(arm, window, valid, nc, c):
    cache, (jdt, tdt), tol = ARMS[arm]
    case = _case(11, cache=cache, window=window, valid=valid)
    got = _model(case, tdt, nc=nc, c=c).float()
    torch.testing.assert_close(got, _port(case, tdt).float(), **TOL[tol])
    np.testing.assert_allclose(got.numpy(), _jax_attend(case, jdt), **TOL[tol])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_does_not_depend_on_the_batch_or_kv_window(dtype):
    """A row's bits alone equal its bits in a batch of 8, and over the
    first 80 columns (every position below 80) equal them over all 96."""
    case = _case(12, b=8, s=96)
    case["pos"] = np.minimum(case["pos"], 79)
    batch = _model(case, dtype, nc=2, c=8)
    for r in (0, 5):
        one = {**case, **{x: case[x][r:r + 1] for x in ("q", "k", "v", "pos")}}
        assert torch.equal(_model(one, dtype, nc=2, c=8)[0], batch[r])
    assert torch.equal(_model(case, dtype, nc=2, c=8, kv_window=80), batch)


EDGE_NC, EDGE_C = 4, 8
EDGES = {"0": 0, "C-1": EDGE_C - 1, "C": EDGE_C, "NC*C-1": EDGE_NC * EDGE_C - 1,
         "NC*C": EDGE_NC * EDGE_C, "NC*C+1": EDGE_NC * EDGE_C + 1}


@pytest.mark.parametrize("at", list(EDGES))
def test_split_at_the_chunk_and_cluster_edges(at):
    """Positions where one part is active, where all are, and where part 0
    takes a second chunk (NC 4, C 8, S 48), against the plain version."""
    nc, c = EDGE_NC, EDGE_C
    case = _case(13, b=2, s=48)
    case["pos"][:] = EDGES[at]
    for dtype, tol in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        torch.testing.assert_close(_model(case, dtype, nc=nc, c=c).float(),
                                   _port(case, dtype).float(), **TOL[tol])


def test_split_row_with_no_valid_key_is_zero():
    case = _case(14, b=2, valid=True)
    case["valid"][0] = False
    out = _model(case, torch.float32)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    torch.testing.assert_close(out[1], _port(case, torch.float32)[1], **TOL["f32"])
