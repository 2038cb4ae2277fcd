"""Mamba2 (SSD) block: prefill forward and one-token decode (counterpart of
``repro/models/ssm.py``).

dt and A are computed in float32; x, B and C stay in the compute dtype, as
in the reference.  The depthwise causal conv is ``F.conv1d`` (the
reference uses XLA's conv there, not a Pallas kernel); the SSD scan goes
through ``ops.ssd``, which on the card also gives the prefill's final
state (``ssm_train_with_state``); the decode recurrence is plain PyTorch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common


def ssm_dims(cfg: ModelConfig):
    """(d_inner, n_heads, width of the conv'd x|B|C channels)."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    d_xbc = di + 2 * s.n_groups * s.d_state
    return di, nh, d_xbc


class SSM(torch.nn.Module):
    """The reference's parameters.  ``in_proj`` / ``out_proj`` weights are
    stored (out, in); ``conv_w`` keeps the reference's (W, C) layout."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        s = cfg.ssm
        di, nh, d_xbc = ssm_dims(cfg)
        kw = {"device": device, "dtype": dtype}
        d_in_proj = 2 * di + 2 * s.n_groups * s.d_state + nh
        self.in_proj = torch.nn.Linear(cfg.d_model, d_in_proj, bias=False,
                                       **kw)
        self.out_proj = torch.nn.Linear(di, cfg.d_model, bias=False, **kw)
        self.conv_w = torch.nn.Parameter(torch.empty(s.conv_width, d_xbc,
                                                     **kw))
        self.conv_b = torch.nn.Parameter(torch.empty(d_xbc, **kw))
        self.A_log = torch.nn.Parameter(torch.empty(nh, **kw))
        self.D = torch.nn.Parameter(torch.empty(nh, **kw))
        self.dt_bias = torch.nn.Parameter(torch.empty(nh, **kw))
        self.gate_norm = torch.nn.Parameter(torch.empty(di, **kw))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The reference's init (``ssm_init``), from ``gen``."""
        nh = self.A_log.shape[0]
        common.dense_init(self.in_proj.weight, gen)
        common.dense_init(self.out_proj.weight, gen)
        self.conv_w.normal_(0.0, self.conv_w.shape[0] ** -0.5, generator=gen)
        self.conv_b.zero_()
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, nh)))
        self.D.fill_(1.0)
        self.dt_bias.normal_(0.0, 0.5, generator=gen)
        self.gate_norm.fill_(1.0)


class Layer(torch.nn.Module):
    """A pre-norm Mamba2 layer's parameters (Mamba2's and Zamba2's)."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        self.ln = torch.nn.Parameter(torch.empty(cfg.d_model, device=device,
                                                 dtype=dtype))
        self.ssm = SSM(cfg, device=device, dtype=dtype)


def _split_in_proj(proj, cfg: ModelConfig):
    """-> z (.., di), xbc (.., d_xbc), dt (.., nh)."""
    di, _, d_xbc = ssm_dims(cfg)
    return torch.split(proj, [di, d_xbc, proj.shape[-1] - di - d_xbc],
                       dim=-1)


def _causal_conv(xbc, w, b):
    """Depthwise causal conv1d + SiLU.  xbc: (B, S, C); w: (W, C)."""
    width, c = w.shape
    pad = F.pad(xbc.transpose(1, 2), (width - 1, 0))
    out = F.conv1d(pad, w.T[:, None, :], groups=c)
    return F.silu(out.transpose(1, 2) + b)


def _dt_a(ssm: SSM, dt):
    dt = F.softplus(dt.float() + ssm.dt_bias.float())
    return dt, -torch.exp(ssm.A_log.float())


def _forward(ssm: SSM, x, cfg: ModelConfig, ex, return_state: bool):
    """-> (out (B, S, D), the raw pre-conv x|B|C (B, S, d_xbc), the final
    SSD state (B, H, P, N) float32 or None)."""
    s_cfg = cfg.ssm
    b, s, _ = x.shape
    di, nh, _ = ssm_dims(cfg)
    gn = s_cfg.n_groups * s_cfg.d_state

    z, xbc_raw, dt = _split_in_proj(ssm.in_proj(x), cfg)
    xbc = _causal_conv(xbc_raw, ssm.conv_w, ssm.conv_b)
    xs, bmat, cmat = torch.split(xbc, [di, gn, gn], dim=-1)
    xs = xs.reshape(b, s, nh, s_cfg.head_dim).contiguous()
    bmat = bmat.reshape(b, s, s_cfg.n_groups, s_cfg.d_state).contiguous()
    cmat = cmat.reshape(b, s, s_cfg.n_groups, s_cfg.d_state).contiguous()
    dt, a = _dt_a(ssm, dt)

    y = ops.ssd(xs, dt.contiguous(), a, bmat, cmat, chunk=ex.ssd_chunk,
                return_state=return_state)
    y, state = y if return_state else (y, None)
    y = y + xs * ssm.D.to(y.dtype)[None, None, :, None]
    y = y.reshape(b, s, di)
    y = common.norm(y * F.silu(z), ssm.gate_norm, cfg.norm_eps)
    return ssm.out_proj(y), xbc_raw, state


def ssm_train(ssm: SSM, x, cfg: ModelConfig, ex):
    """Full-sequence forward (prefill) without the state.  x: (B, S, D) ->
    (B, S, D)."""
    return _forward(ssm, x, cfg, ex, return_state=False)[0]


def ssm_train_with_state(ssm: SSM, x, cfg: ModelConfig, ex):
    """Full-sequence forward that also returns the decode state (the
    reference's ``ssm_lm._train_with_state``).  x: (B, S, D) -> (out
    (B, S, D), conv state: the last W-1 rows of the raw x|B|C in the
    compute dtype, (B, W-1, d_xbc), final SSD state (B, H, P, N)
    float32)."""
    out, xbc_raw, state = _forward(ssm, x, cfg, ex, return_state=True)
    conv = xbc_raw[:, -(cfg.ssm.conv_width - 1):].to(ex.compute_dtype)
    return out, conv, state


def ssm_init_state(cfg: ModelConfig, n_layers: int, batch: int, dtype,
                   device):
    """Zeroed decode state of ``n_layers`` layers: the conv window
    (L, B, W-1, d_xbc) in ``dtype`` and the SSM state (L, B, H, P, N) in
    float32."""
    s = cfg.ssm
    _, nh, d_xbc = ssm_dims(cfg)
    return {
        "conv": torch.zeros((n_layers, batch, s.conv_width - 1, d_xbc),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((n_layers, batch, nh, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def ssm_decode(ssm: SSM, x, conv_state, ssm_state, cfg: ModelConfig):
    """One-token step.  x: (B, 1, D); conv_state (B, W-1, d_xbc) and
    ssm_state (B, H, P, N) of this layer are updated in place (the
    reference returns new ones).  Returns y (B, 1, D)."""
    s_cfg = cfg.ssm
    b = x.shape[0]
    di, nh, _ = ssm_dims(cfg)
    gn = s_cfg.n_groups * s_cfg.d_state

    z, xbc, dt = _split_in_proj(ssm.in_proj(x[:, 0]), cfg)
    # conv over the stored window + the current input, in float32
    win = torch.cat([conv_state, xbc[:, None, :].to(conv_state.dtype)], dim=1)
    conv = torch.einsum("bwc,wc->bc", win.float(), ssm.conv_w.float())
    xbc_t = F.silu(conv + ssm.conv_b.float())
    conv_state.copy_(win[:, 1:])

    xs, bmat, cmat = torch.split(xbc_t, [di, gn, gn], dim=-1)
    xs = xs.reshape(b, nh, s_cfg.head_dim)
    rep = nh // s_cfg.n_groups
    bh = bmat.reshape(b, s_cfg.n_groups, s_cfg.d_state).repeat_interleave(
        rep, dim=1)                                        # (B, H, N)
    ch = cmat.reshape(b, s_cfg.n_groups, s_cfg.d_state).repeat_interleave(
        rep, dim=1)
    dt, a = _dt_a(ssm, dt)

    decay = torch.exp(dt * a[None, :])[..., None, None]     # (B, H, 1, 1)
    upd = dt[..., None, None] * bh[:, :, None, :] * xs[..., :, None]
    ssm_state.mul_(decay).add_(upd)
    y = torch.einsum("bhpn,bhn->bhp", ssm_state, ch)
    y = y + xs * ssm.D.float()[None, :, None]
    y = y.reshape(b, di).to(x.dtype)
    y = common.norm(y * F.silu(z), ssm.gate_norm, cfg.norm_eps)
    return ssm.out_proj(y)[:, None, :]
