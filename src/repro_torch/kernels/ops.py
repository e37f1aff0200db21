"""Public wrappers around the hand-written kernels, in the model's layout.

A wrapper dispatches on the device of the tensors it is given: on the CPU
it runs the kernel's plain version (``repro_torch.kernels.ref``); on a CUDA
tensor it launches the kernel or raises, and never falls back.  Each
wrapper counts its launches in a plain integer attribute (``.launches``),
so a run can show that its main path went through the kernel.

Each wrapper is differentiable.  On the CPU autograd goes through the plain
version itself.  On the card an ``autograd.Function`` runs the kernel
forward and, in its backward, recomputes the plain version from the saved
inputs and takes its gradients (the standard recompute backward, as the
JAX package's ``_flash_bwd`` does for flash attention; none of the
reference's backwards is a Pallas kernel).  Where autograd records nothing
(grad mode off, as when serving, or no input requiring a gradient) the
wrapper launches the kernel without the ``Function``.  A run under
``torch.utils.checkpoint`` launches each forward twice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gmm as _gmm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd as _ssd


def _needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on these inputs."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _recompute_grads(plain, inputs, needs, grads):
    """Gradients of ``plain(*inputs)`` (a tuple of outputs) for ``grads``,
    through autograd on detached copies of the inputs; None for an input
    whose ``needs`` entry is False.  An output that depends on no such
    input (K2's cum, where only x needs a gradient) is left out."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        wanted = [t for t in leaves if t.requires_grad]
        outs = [(o, g) for o, g in zip(plain(*leaves), grads)
                if o.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in outs], wanted,
                                       [g for _, g in outs])
                   if wanted else ())
    return tuple(next(got) if t.requires_grad else None for t in leaves)


def _plain_attention(causal, scale, q_offset=0):
    def plain(q, k, v):
        return (_ref.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, scale=scale, q_offset=q_offset).transpose(1, 2),)
    return plain


def _launch_flash(q, k, v, causal, scale, q_offset=0):
    # the offset is named only where there is one: a call without it is
    # the unshifted kernel's, as it always was
    kw = {"q_offset": q_offset} if q_offset else {}
    o = _fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale, **kw)
    flash_attention.launches += 1
    return o


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset=0):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale, ctx.q_offset = causal, scale, q_offset
        return _launch_flash(q, k, v, causal, scale, q_offset)

    @staticmethod
    def backward(ctx, g):
        return _recompute_grads(
            _plain_attention(ctx.causal, ctx.scale, ctx.q_offset),
            ctx.saved_tensors, ctx.needs_input_grad[:3], (g,)) + (
                None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: [B,S,H,hd]; k: [B,T,K,hd]; v: [B,T,K,hd_v] → [B,S,H,hd_v] (GQA).
    ``q_offset``: the key position of query row 0 for the causal mask
    (T − S for the last S rows of T; a rank's first row of a sequence
    split over the model group).

    On the card: K1 forward; backward recomputes ``ref.flash_attention_ref``
    at the same offset.
    """
    if q.device.type == "cpu":
        return _plain_attention(causal, scale, q_offset)(q, k, v)[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, "
                         f"not {q.device}")
    if not _needs_grad(q, k, v):
        return _launch_flash(q, k, v, causal, scale, q_offset)
    return _FlashAttention.apply(q, k, v, causal, scale, q_offset)


flash_attention.launches = 0


def _plain_intra_chunk(chunk):
    def plain(xh, dt, A, Bm, Cm):
        return _ref.ssd_intra_chunk_ref(*_ref.to_chunks(xh, dt, A, Bm, Cm,
                                                        chunk))
    return plain


def _launch_intra_chunk(xh, dt, A, Bm, Cm, chunk):
    out = _ssd.ssd_intra_chunk_fwd(xh, dt, A, Bm, Cm, chunk)
    ssd_chunked.launches += 1
    return out


class _SsdIntraChunk(torch.autograd.Function):
    """K2's (y, states, cum) from the model's (xh, dt, A, Bm, Cm); all three
    outputs carry gradients (cum feeds the inter-chunk decays)."""

    @staticmethod
    def forward(ctx, xh, dt, A, Bm, Cm, chunk):
        ctx.save_for_backward(xh, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return _launch_intra_chunk(xh, dt, A, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, gy, gstates, gcum):
        return _recompute_grads(_plain_intra_chunk(ctx.chunk),
                                ctx.saved_tensors, ctx.needs_input_grad[:5],
                                (gy, gstates, gcum)) + (None,)


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None, seq=None):
    """The chunked SSD scan with its intra-chunk term on K2.

    xh: [B,L,H,P], dt: [B,L,H] (post-softplus, fp32), A: [H] (negative,
    fp32), Bm/Cm: [B,L,G,N] with H % G == 0; init_state: [B,H,P,N] or None
    for zeros.  Returns (y [B,L,H,P] in xh's dtype, final state [B,H,P,N]
    fp32).  L must be a multiple of ``chunk``.  The inter-chunk recurrence
    and its correction are linear and cheap, and stay plain PyTorch.  On
    the card the intra-chunk term's backward recomputes
    ``ref.ssd_intra_chunk_ref``.

    ``seq`` (a ``sync.seq.Seq``, in place of ``init_state``): the inputs
    are this rank's rows of a sequence split over the grid's model group.
    The rank scans its chunks from a zero state, then takes the state
    entering its rows from the ranks before it (``seq.prefix`` of its
    final state and total decay) and adds that state's part to every
    chunk's entering state and to its final state, as a scan from it
    would: one K2 launch, differentiable throughout.
    """
    if seq is not None and init_state is not None:
        raise ValueError("ssd_chunked: a split sequence starts from the "
                         "state its ranks hand on, not an init_state")
    Bsz, L, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if chunk <= 0 or L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk {chunk}")
    nc = L // chunk
    if xh.device.type == "cpu":
        y_intra, states, cum = _plain_intra_chunk(chunk)(xh, dt, A, Bm, Cm)
    elif xh.device.type == "cuda":
        intra = (_SsdIntraChunk.apply if _needs_grad(xh, dt, A, Bm, Cm)
                 else _launch_intra_chunk)
        y_intra, states, cum = intra(xh, dt, A, Bm, Cm, chunk)
    else:
        raise ValueError(f"ssd_chunked runs on cpu or cuda, not {xh.device}")

    states = states.reshape(Bsz, H, nc, N, P)
    cum = cum.reshape(Bsz, H, nc, chunk)
    chunk_decay = torch.exp(cum[..., -1])                   # [B,H,nc]
    s = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
         if init_state is None else init_state.float())
    prev = []                                               # state entering c
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[..., c, None, None] + states[:, :, c].transpose(
            -1, -2)
    prev = torch.stack(prev, dim=2)                         # [B,H,nc,P,N]
    if seq is not None:
        # the entering state decays to chunk c by the chunks before c
        logd = cum[..., -1]                                 # [B,H,nc]
        total = torch.exp(logd.sum(-1))                     # [B,H]
        enter = seq.prefix(s, total)
        before = torch.exp(torch.cumsum(logd, -1) - logd)
        prev = prev + before[..., None, None] * enter[:, :, None]
        s = s + total[..., None, None] * enter

    # y_inter[b,c,q,h] = exp(cum) · (C of h's group) · prev[b,h,c]; the
    # group's C is contracted once per head group, not repeated per head
    hpg = H // G
    Cc = Cm.reshape(Bsz, nc, chunk, G, N).float()
    y_inter = torch.einsum("bcqgn,bgjcpn->bcqgjp", Cc,
                           prev.reshape(Bsz, G, hpg, nc, P, N))
    decay_from_start = torch.exp(cum).permute(0, 2, 3, 1)   # [B,nc,Q,H]
    y_inter = y_inter.reshape(Bsz, nc, chunk, H, P) \
        * decay_from_start[..., None]
    y_intra = y_intra.reshape(Bsz, H, nc, chunk, P).permute(0, 2, 3, 1, 4)
    y = (y_intra + y_inter).reshape(Bsz, L, H, P)
    return y.to(xh.dtype), s


ssd_chunked.launches = 0


def _launch_gmm(x, w):
    out = _gmm.gmm_fwd(x, w)
    grouped_matmul.launches += 1
    return out


class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _launch_gmm(x, w)

    @staticmethod
    def backward(ctx, g):
        return _recompute_grads(lambda x, w: (_ref.gmm_ref(x, w),),
                                ctx.saved_tensors, ctx.needs_input_grad, (g,))


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [E,C,d]; w: [E,d,f] → [E,C,f] in x's dtype, summed in fp32: the
    per-expert products of the MoE layer, on K3.

    The JAX wrapper's ``block_c/block_f/block_d`` tile the TPU kernel; K3
    picks its own tiles, so the port takes none.  On the card the backward
    recomputes ``ref.gmm_ref``.
    """
    if x.device.type == "cpu":
        return _ref.gmm_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul runs on cpu or cuda, not {x.device}")
    if not _needs_grad(x, w):
        return _launch_gmm(x, w)
    return _GroupedMatmul.apply(x, w)


grouped_matmul.launches = 0
