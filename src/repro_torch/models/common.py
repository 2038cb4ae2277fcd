"""Shared model-execution config + small building blocks (counterpart of
``repro/models/common.py``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

REMAT_POLICIES = ("none", "full", "dots")


@dataclass(frozen=True)
class ExecConfig:
    """Runtime execution knobs (orthogonal to the architecture config)."""
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    # activation checkpointing of each family's layer body in a train
    # forward (``wrap_remat``): 'none' | 'full' | 'dots'
    remat: str = "none"
    # key tile of the plain attention path (the CUDA kernel's is fixed)
    attn_block: int = 128
    # SSD chunk length (ops.ssd cuts it to the sequence length)
    ssd_chunk: int = 128
    device: str = "cuda"
    # MoE dispatch: 'dense' (capacity buckets on one rank, models/moe.py)
    # or 'a2a' (the all-to-all over the mesh's model axis,
    # parallel/moe_a2a.py; needs ``mesh``)
    moe_impl: str = "dense"
    # the torch DeviceMesh the step runs on, required when moe_impl ==
    # "a2a"
    mesh: Any = None

    def __post_init__(self):
        if self.remat not in REMAT_POLICIES:
            raise ValueError(f"remat={self.remat!r}: not one of "
                             f"{REMAT_POLICIES}")

    def wrap_remat(self, fn):
        """``fn`` (a layer body: tensors in, tensors out) under this
        config's activation checkpointing, which applies only while grad
        is enabled (prefill and decode run ``fn`` itself):
          * 'none': ``fn``;
          * 'full': nothing inside is saved for the backward but the
            inputs; the backward runs ``fn`` again
            (``torch.utils.checkpoint``, non-reentrant);
          * 'dots': the outputs of the matrix products that torch ops
            compute (``DOT_OPS``) are saved and everything else is
            recomputed, the hand kernels included: jax's
            ``checkpoint_dots``, under which a ``pallas_call`` is not a
            ``dot_general``."""
        if self.remat == "none":
            return fn
        from torch.utils.checkpoint import checkpoint
        kw = {"context_fn": _dots_contexts} if self.remat == "dots" else {}

        def run(*args):
            if not torch.is_grad_enabled():
                return fn(*args)
            return checkpoint(fn, *args, use_reentrant=False, **kw)

        return run


# the ops whose outputs 'dots' saves: what ``F.linear``, ``matmul`` and
# ``einsum`` lower to on operands of two or more dims
DOT_OPS = (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
           torch.ops.aten.baddbmm)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op.overloadpacket in DOT_OPS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_dots_policy)


def check_device(device) -> torch.device:
    """The device to run on; a CUDA device that is not there raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; ask for the CPU "
                           "explicitly (device='cpu' / --device cpu)")
    return device


def dense_init(weight: torch.Tensor, generator: torch.Generator,
               scale=None) -> None:
    """Fill an (out, in) weight with normal * in**-0.5, in place."""
    if scale is None:
        scale = weight.shape[1] ** -0.5
    with torch.no_grad():
        weight.normal_(0.0, scale, generator=generator)


# ---------------------------------------------------------------------------
# RoPE (half-split, as repro.models.common.apply_rope)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (S,) -> (cos, sin), each (1, 1, S, head_dim/2) fp32.

    Every layer of one forward shares them, so a forward computes them
    once where the reference recomputes them in each layer (same values).
    """
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = (positions[:, None].float() * freqs[None, :])[None, None]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, H, S, D); cos/sin from ``rope_angles``."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Norms / MLP
# ---------------------------------------------------------------------------
def norm(x, w, eps):
    return ops.rmsnorm(x, w, eps=eps)


class MLP(torch.nn.Module):
    def __init__(self, d_model, d_ff, gated: bool, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"bias": False, "device": device, "dtype": dtype}
        self.w1 = torch.nn.Linear(d_model, d_ff, **kw)
        self.w2 = torch.nn.Linear(d_ff, d_model, **kw)
        self.w3 = torch.nn.Linear(d_model, d_ff, **kw) if gated else None


def mlp_apply(mlp: MLP, x, gated: bool):
    if gated:
        h = F.silu(mlp.w1(x)) * mlp.w3(x)
    else:
        h = F.gelu(mlp.w1(x), approximate="tanh")
    return mlp.w2(h)


def cross_entropy(logits, labels, *, logit_softcap=0.0, mask=None):
    """Mean next-token loss in float32.  logits: (B, S, V); labels: (B, S)
    int; mask: None or (B, S), the positions that count.  The reference
    picks the gold logit with a masked reduction (for vocab-sharded
    logits); a gather is the same sum on one device."""
    logits = logits.float()
    if logit_softcap:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def tied_head_loss(x, embed, batch):
    """-> (loss, {"ce", "aux"}): the mean cross-entropy of the tied head's
    logits ``x @ embed.T`` against ``batch["labels"]`` (over
    ``batch["loss_mask"]`` where given); no aux loss (the reference's
    ssm, hybrid and encdec losses)."""
    ce = cross_entropy(x @ embed.T, batch["labels"],
                       mask=batch.get("loss_mask"))
    return ce, {"ce": ce, "aux": 0.0}
