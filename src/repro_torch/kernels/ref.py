"""Plain PyTorch versions of the hand-written kernels (the ground truth).

Each is the straightforward fp32 formulation of what its kernel computes.
The kernel wrappers in ``repro_torch.kernels.ops`` run these for tensors on
the CPU; on the card they are what a kernel is held against.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def check_q_offset(S: int, T: int, causal: bool, q_offset: int) -> None:
    """A query offset is at least 0 and, causal, leaves the S query rows
    inside the T keys (K1's wrapper checks the same)."""
    if q_offset < 0 or (causal and q_offset + S > T):
        raise ValueError(f"q_offset {q_offset} must be at least 0 and, "
                         f"causal, at most T - S = {T - S}")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: float | None = None,
                        q_offset: int = 0) -> torch.Tensor:
    """q: [B,H,S,hd]; k,v: [B,K,T,hd|hd_v].  Plain softmax attention in fp32.
    ``q_offset``: the key position of query row 0 (causal: row i sees keys
    0 .. q_offset + i)."""
    B, H, S, hd = q.shape
    K, T = k.shape[1], k.shape[2]
    check_q_offset(S, T, causal, q_offset)
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    if causal:
        mask = (q_offset + torch.arange(S, device=q.device)[:, None]
                >= torch.arange(T, device=q.device)[None, :])
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, v.float()).to(q.dtype)


def ssd_intra_chunk_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        Bm: torch.Tensor, Cm: torch.Tensor):
    """The SSD intra-chunk term, K2's plain version.

    x: [BH,nc,Q,P], dt: [BH,nc,Q], A: [BH], Bm/Cm: [BG,nc,Q,N]; head row i
    reads group row i // (BH/BG).  Returns (y [BH,nc,Q,P], states
    [BH,nc,N,P], cum [BH,nc,Q]), all fp32.  As in the kernel, cum is
    summed in fp64 and the exponents (differences of cums) are taken in
    fp64 before they are rounded to fp32: near cum ~ -1e3 an fp32 ulp is
    6e-5, so differences of fp32 cums would move every near-diagonal decay
    by up to ~1e-4 relative.  So the two agree whatever the order of the
    sum.
    """
    BH, nc, Q, P = x.shape
    hpg = BH // Bm.shape[0]
    x, dt = x.float(), dt.float()
    Bh = Bm.float().repeat_interleave(hpg, dim=0)
    Ch = Cm.float().repeat_interleave(hpg, dim=0)

    dA = dt * A.float()[:, None, None]
    cum64 = torch.cumsum(dA.double(), dim=-1)
    seg = (cum64[..., :, None] - cum64[..., None, :]).float()
    tril = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    Lmat = torch.where(tril, torch.exp(torch.where(tril, seg, 0.0)), 0.0)
    CB = torch.einsum("hcqn,hckn->hcqk", Ch, Bh)
    xdt = x * dt[..., None]
    y = torch.einsum("hcqk,hckp->hcqp", CB * Lmat, xdt)
    decay_end = torch.exp((cum64[..., -1:] - cum64).float())
    states = torch.einsum("hcqn,hcqp->hcnp", Bh * decay_end[..., None], xdt)
    return y, states, cum64.float()


def to_chunks(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor, chunk: int):
    """The model's x [B,L,H,P], dt [B,L,H], A [H], Bm/Cm [B,L,G,N] in the
    chunked layout ``ssd_intra_chunk_ref`` takes: (batch, head) and
    (batch, group) flattened, the sequence cut into chunks."""
    Bsz, L, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = L // chunk

    def heads_first(t, n, d):
        return (t.reshape(Bsz, nc, chunk, n, d).permute(0, 3, 1, 2, 4)
                .reshape(Bsz * n, nc, chunk, d))

    dt_k = (dt.reshape(Bsz, nc, chunk, H).permute(0, 3, 1, 2)
            .reshape(Bsz * H, nc, chunk))
    return (heads_first(xh, H, P), dt_k, A.repeat(Bsz),
            heads_first(Bm, G, N), heads_first(Cm, G, N))


def ssd_sequential_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor,
                       init_state: torch.Tensor | None = None):
    """The SSM recurrence one step at a time: the oracle for the whole SSD
    layer (chunked == sequential is the state-space-duality claim).

    x: [B,L,H,P], dt: [B,L,H], A: [H], Bm/Cm: [B,L,G,N].
    Returns (y [B,L,H,P] in x's dtype, final_state [B,H,P,N] fp32).
    """
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    Bh = Bm.float().repeat_interleave(hpg, dim=2)
    Ch = Cm.float().repeat_interleave(hpg, dim=2)
    xf, dtf, A = x.float(), dt.float(), A.float()
    s = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(L):
        dec = torch.exp(dtf[:, t] * A)                             # [B,H]
        s = s * dec[..., None, None] + torch.einsum(
            "bhn,bhp,bh->bhpn", Bh[:, t], xf[:, t], dtf[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], s))
    return torch.stack(ys, dim=1).to(x.dtype), s


def gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [E,C,d]; w: [E,d,f] → [E,C,f]: the grouped matmul, K3's plain
    version, summed in fp32 and returned in x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
