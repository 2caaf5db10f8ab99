"""Plain PyTorch kernel oracles, ported from `repro.kernels.ref`.

`naive_attention` is the quadratic SDPA oracle.  `flash_attention_ref` is
the forward of the chunked online-softmax attention (fp32 m, l, acc) and is
the plain twin of the CUDA kernel in `flash_attention.py`.  Unlike the JAX
reference, it walks a ragged last KV block instead of dropping the keys past
the last whole `block_k` (`skv // block_k` in `repro.kernels.ref._flash_fwd`).
`wkv6_ref` is the sequential WKV6 recurrence, the plain twin of the CUDA
kernel in `wkv6.py`.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(q_pos, k_pos, causal: bool, window: int | None):
    mask = torch.ones(q_pos.shape[0], k_pos.shape[0], dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    return mask


def naive_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, q_offset: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """Quadratic SDPA oracle.  q: (B,Sq,H,hd); k,v: (B,Skv,H,hd).
    Logits and softmax in fp32; probabilities cast to q's dtype for PV."""
    hd = q.shape[-1]
    scale = hd ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    sq, skv = q.shape[1], k.shape[1]
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(skv, device=q.device)
    logits = logits.masked_fill(~_mask(q_pos, k_pos, causal, window), NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(q.dtype))


def flash_attention_ref(q, k, v, block_k: int = 512, causal: bool = True,
                        window: int | None = None, q_offset: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """Memory-efficient exact attention: O(Sq*block_k) live logits.

    Shapes as `naive_attention`; k/v may also hold a single shared head
    (broadcast over q's heads) and v may have its own feature dim.  The
    output is `acc / max(l, 1e-30)` cast to q's dtype."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    scale = hd ** -0.5 if scale is None else scale
    qf = (q.float() * scale).transpose(1, 2)            # (B,H,Sq,hd)
    kf = k.float().transpose(1, 2)                      # (B,H|1,Skv,hd)
    vf = v.float().transpose(1, 2)
    q_pos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, vf.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for start in range(0, skv, block_k):
        ks = kf[:, :, start:start + block_k]
        vs = vf[:, :, start:start + block_k]
        s = qf @ ks.transpose(-1, -2)
        k_pos = torch.arange(start, start + ks.shape[2], device=q.device)
        s = s.masked_fill(~_mask(q_pos, k_pos, causal, window), NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vs
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def wkv6_ref(r, k, v, w, u, s0=None):
    """Sequential WKV6 in fp32.  r,k,v,w: (B,S,H,hd); u: (H,hd);
    s0: (B,H,hd,hd) or None (zeros).  Per step
    y_t = r_t (S + diag(u) k_t^T v_t),  S <- diag(w_t) S + k_t^T v_t.
    Returns (y: (B,S,H,hd) fp32, s_final: (B,H,hd,hd) fp32)."""
    b, s, h, hd = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    state = (torch.zeros((b, h, hd, hd), dtype=torch.float32,
                         device=r.device) if s0 is None else s0.float())
    y = torch.empty((b, s, h, hd), dtype=torch.float32, device=r.device)
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        y[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t], state + uf * kv)
        state = wf[:, t, :, :, None] * state + kv
    return y, state
