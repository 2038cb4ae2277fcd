"""Dense PyTorch oracles for the ported kernels (counterpart of
``repro/kernels/ref.py``): the CPU path of the model zoo and the ground
truth the kernels are held against."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or in float64 where it already is: the oracles
    compute in float32, and in float64 for ``torch.autograd.gradcheck``."""
    return t if t.dtype == torch.float64 else t.float()


def attention_ref(q, k, v, *, causal=True, window=None, softcap=0.0,
                  scale=None):
    """Dense reference attention.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D).  GQA via head repetition.
    ``window``: keys with row-col >= window are masked.  Causal assumes
    Sq == Sk or q occupies the LAST Sq positions of the Sk key range.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    cols = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= (rows - cols) < window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def rmsnorm_ref(x, w, *, eps=1e-6, weight_offset=0.0):
    xf = wide(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (weight_offset + wide(w))
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------
def ssd_ref(x, dt, A, B, C, D=None, *, initial_state=None):
    """Per-step recurrence oracle for the SSD operator.

    x: (Bb, S, H, P); dt: (Bb, S, H) positive steps; A: (H,) negative
    decay rates; B, C: (Bb, S, G, N) with H % G == 0; D: (H,) or None.
    Returns y (Bb, S, H, P) in x's dtype and the final state
    (Bb, H, P, N) in float32.
    """
    bb, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    a = A.float()
    xf, dtf = x.float(), dt.float()
    bh = B.float().repeat_interleave(rep, dim=2)   # (Bb, S, H, N)
    ch = C.float().repeat_interleave(rep, dim=2)
    state = (torch.zeros((bb, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * a[None, :])[..., None, None]
        upd = (dtf[:, t, :, None, None] * bh[:, t, :, None, :]
               * xf[:, t, :, :, None])
        state = state * decay + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, t]))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + xf * D.float()[None, None, :, None]
    return y.to(x.dtype), state


def ssd_chunked_ref(x, dt, A, B, C, D=None, *, chunk=64, initial_state=None):
    """Chunked (matrix-form) SSD: the same function as ``ssd_ref``, the
    algorithm the kernel implements, in float32 (float64 inputs stay in
    float64).  S % chunk == 0."""
    bb, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    nc = s // chunk
    a = wide(A)
    xc = wide(x).reshape(bb, nc, chunk, h, p)
    dtc = wide(dt).reshape(bb, nc, chunk, h)
    bc = wide(B).repeat_interleave(rep, dim=2).reshape(bb, nc, chunk, h, n)
    cc = wide(C).repeat_interleave(rep, dim=2).reshape(bb, nc, chunk, h, n)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    state = (torch.zeros((bb, h, p, n), dtype=xc.dtype, device=x.device)
             if initial_state is None else wide(initial_state))
    ys = []
    for ci in range(nc):
        xq, dtq, bq, cq = xc[:, ci], dtc[:, ci], bc[:, ci], cc[:, ci]
        cum = torch.cumsum(dtq * a[None, None, :], dim=1)   # L_i, (Bb,Q,H)
        # intra-chunk: M[i,j] = C_i.B_j exp(L_i - L_j) for j <= i
        cb = torch.einsum("bqhn,bkhn->bhqk", cq, bq)
        dec = (cum[:, :, None, :] - cum[:, None, :, :]).permute(0, 3, 1, 2)
        # mask BEFORE the exp: the entries above the diagonal are > 0
        dec = torch.where(causal, dec, 0.0)
        m = cb * torch.where(causal, torch.exp(dec), 0.0)
        y_intra = torch.einsum("bhqk,bkhp->bqhp", m, xq * dtq[..., None])
        # inter-chunk: y_i += C_i . (exp(L_i) state)
        y_inter = torch.einsum("bhpn,bqhn->bqhp", state,
                               cq * torch.exp(cum)[..., None])
        # state: h' = exp(L_Q) h + sum_j exp(L_Q - L_j) dt_j x_j B_j^T
        tot = cum[:, -1]                                      # (Bb, H)
        w = torch.exp(tot[:, None, :] - cum) * dtq
        upd = torch.einsum("bqhn,bqhp->bhpn", bq * w[..., None], xq)
        state = state * torch.exp(tot)[..., None, None] + upd
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(bb, s, h, p)
    if D is not None:
        y = y + wide(x) * wide(D)[None, None, :, None]
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# Grouped matmul (MoE expert FFN)
# ---------------------------------------------------------------------------
def moe_gmm_ref(x, w, group_sizes):
    """x: (T, K) tokens sorted by expert; w: (E, K, N); group_sizes: (E,).

    Returns (T, N) in x's dtype, from float32 products.  Rows beyond
    sum(group_sizes) are zeros.  A Python-loop oracle for the tests: the
    port's contract (``ops.moe_gmm``) takes block ids, not group sizes.
    """
    out = torch.zeros((x.shape[0], w.shape[-1]), dtype=x.dtype,
                      device=x.device)
    start = 0
    for e, g in enumerate(int(g) for g in group_sizes):
        if g == 0:
            continue
        seg = x[start:start + g].float() @ w[e].float()
        out[start:start + g] = seg.to(x.dtype)
        start += g
    return out
