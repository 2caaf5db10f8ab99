"""Plain PyTorch kernel oracles, ported from `repro.kernels.ref`.

`naive_attention` is the quadratic SDPA oracle.  `flash_attention_ref` is
the chunked online-softmax attention (fp32 m, l, acc) with the reference's
recompute VJP, as a `torch.autograd.Function`: `flash_fwd` is its forward
(the plain twin of the CUDA forward kernel, lse included) and
`flash_attention_bwd_plain` its backward (the plain twin of the CUDA
backward kernel).  Unlike the JAX reference, both walk a ragged last KV
block instead of dropping the keys past the last whole `block_k` (the JAX
forward's `skv // block_k`, R5) or raising (its VJP's reshape, R8).
`wkv6_ref` is the sequential WKV6 recurrence, the plain twin of the CUDA
forward kernel in `wkv6.py`; autograd differentiates it as it stands.
`wkv6_bwd_plain` is its reverse walk, the plain twin of the CUDA backward,
checkpoints and all.  `ssm_scan_bwd_plain` is the selective scan's
reverse walk (the plain twin of the CUDA backward in `selective_scan.py`),
from the states `ssm_checkpoints` gives.
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


def flash_fwd(q, k, v, block_k: int = 512, causal: bool = True,
              window: int | None = None, q_offset: int = 0,
              scale: float | None = None):
    """Memory-efficient exact attention: O(Sq*block_k) live logits.

    Shapes as `naive_attention`; k/v may also hold a single shared head
    (broadcast over q's heads) and v may have its own feature dim.  Returns
    (out, lse): out = acc / max(l, 1e-30) in q's dtype, and the fp32
    (B,H,Sq) lse = m + log(max(l, 1e-30)) of the scaled logits, as the
    reference's VJP computes it (src/repro/kernels/ref.py:118)."""
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
    l = l.clamp_min(1e-30)
    out = acc / l[..., None]
    return out.transpose(1, 2).to(q.dtype), m + torch.log(l)


def flash_attention_bwd_plain(q, k, v, o, do, lse, block_k: int = 512,
                              causal: bool = True, window: int | None = None,
                              q_offset: int = 0, scale: float | None = None,
                              dv_into_dk: bool = False):
    """The reference's recompute VJP (src/repro/kernels/ref.py:106-154),
    KV block by KV block: delta = rowsum(dO * o); per block p = exp(s -
    lse), ds = p (dO v^T - delta) scale, dq += ds k, dk = ds^T q, dv =
    p^T dO.  `o` and `lse` are `flash_fwd`'s.  Returns (dq, dk, dv) in the
    inputs' dtypes (a shared k/v head gets the sum over q's heads); with
    `dv_into_dk` (v being k's first features) (dq, dk + [dv, 0], None),
    the sum taken in fp32 before the rounding."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    scale = hd ** -0.5 if scale is None else scale
    qf = q.float().transpose(1, 2)                      # (B,H,Sq,hd)
    kf = k.float().transpose(1, 2)                      # (B,H|1,Skv,hd)
    vf = v.float().transpose(1, 2)
    dof = do.float().transpose(1, 2)                    # (B,H,Sq,hd_v)
    delta = (dof * o.float().transpose(1, 2)).sum(dim=-1)
    q_pos = torch.arange(sq, device=q.device) + q_offset
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for start in range(0, skv, block_k):
        ks = kf[:, :, start:start + block_k]
        vs = vf[:, :, start:start + block_k]
        s = (qf * scale) @ ks.transpose(-1, -2)
        k_pos = torch.arange(start, start + ks.shape[2], device=q.device)
        s = s.masked_fill(~_mask(q_pos, k_pos, causal, window), NEG_INF)
        p = torch.exp(s - lse[..., None])
        ds = p * (dof @ vs.transpose(-1, -2) - delta[..., None]) * scale
        dq = dq + ds @ ks
        dk_i = ds.transpose(-1, -2) @ qf
        dv_i = p.transpose(-1, -2) @ dof
        if kf.shape[1] != h:                            # one shared head
            dk_i = dk_i.sum(dim=1, keepdim=True)
            dv_i = dv_i.sum(dim=1, keepdim=True)
        dks.append(dk_i)
        dvs.append(dv_i)
    dk = torch.cat(dks, dim=2).transpose(1, 2)
    dv = torch.cat(dvs, dim=2).transpose(1, 2)
    if dv_into_dk:
        dk = torch.cat([dk[..., :dv.shape[-1]] + dv,
                        dk[..., dv.shape[-1]:]], dim=-1)
        return dq.transpose(1, 2).to(q.dtype), dk.to(k.dtype), None
    return (dq.transpose(1, 2).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class _FlashRef(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, block_k, causal, window, q_offset, scale):
        out, lse = flash_fwd(q, k, v, block_k, causal, window, q_offset,
                             scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (block_k, causal, window, q_offset, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd_plain(q, k, v, out, do, lse, *ctx.args),
                None, None, None, None, None)


def flash_attention_ref(q, k, v, block_k: int = 512, causal: bool = True,
                        window: int | None = None, q_offset: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """`flash_fwd`'s output, differentiated by `flash_attention_bwd_plain`
    (recompute, O(Sq*block_k) live logits in both directions)."""
    return _FlashRef.apply(q, k, v, block_k, causal, window, q_offset, scale)


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


def wkv6_checkpoints(k, v, w, s0, every: int):
    """The state before tokens 0, every, 2 every, ... of `wkv6_ref`'s
    recurrence: (B,H,ceil(S/every),hd,hd) fp32, what the CUDA forward
    writes as its checkpoints."""
    b, s, h, hd = k.shape
    kf, vf, wf = (t.float() for t in (k, v, w))
    state = (torch.zeros((b, h, hd, hd), dtype=torch.float32,
                         device=k.device) if s0 is None else s0.float())
    out = []
    for t in range(s):
        if t % every == 0:
            out.append(state)
        state = (wf[:, t, :, :, None] * state
                 + kf[:, t, :, :, None] * vf[:, t, :, None, :])
    return torch.stack(out, 2)


def wkv6_grad_checkpoints(r, w, dy, ds_final, every: int):
    """The gradient of the state after each span of `every` tokens, walked
    back from ds_final by G_{t-1} = diag(w_t) G_t + r_t^T dy_t:
    (B,H,ceil(S/every),hd,hd) fp32, entry c dL/dS after token
    min((c + 1) every, S) - 1, so the last entry is ds_final (zeros where
    it is None; dy None is zeros too).  What the CUDA backward's reverse
    pass writes, and the span walk starts from."""
    b, s, h, hd = r.shape
    rf, wf = r.float(), w.float()
    dyf = torch.zeros_like(rf) if dy is None else dy.float()
    g = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
         if ds_final is None else ds_final.float())
    out = [None] * -(-s // every)
    for t in reversed(range(s)):
        if t == s - 1 or (t + 1) % every == 0:
            out[t // every] = g
        g = (wf[:, t, :, :, None] * g
             + rf[:, t, :, :, None] * dyf[:, t, :, None, :])
    return torch.stack(out, 2)


def wkv6_span_pairs(r, k, v, w, u, dy, ckpt, gck, every: int):
    """dr, dk, dw and du (H,hd) of the backward by the span walk by token
    pairs, as the CUDA kernel `wkv6_pair_kernel` regroups them: each span
    of `every` tokens from its state checkpoint `ckpt` (`wkv6_checkpoints`)
    and its gradient checkpoint `gck` (`wkv6_grad_checkpoints`) alone, with
    T[x][y] = w_{y+1} ... w_{x-1}, E_t = w_0 ... w_{t-1}, F_t = w_{t+1} ...
    w_{L-1} per row, M[x][y] = dy_x . v_y, A_t = dy_t . S_a[i],
    B_t = v_t . G_b[i], Z = G_b[i] . S_a[i]:
        dr_t = E_t A_t + P_t[t] + u k_t c_t
        dk_t = F_t B_t + sum_{s>t} T[s][t] r_s M[s][t] + u r_t c_t
        dw_t = F_t (E_t Z + Q_t) + E_t U_t + sum_{s>t} T[s][t] r_s P_t[s]
    where P_t[s] = sum_{y<t} T[t][y] k_y M[s][y], Q_t = sum_{y<t} T[t][y]
    k_y B_y, U_t = sum_{x>t} T[x][t] r_x A_x, c_t = M[t][t].  Tokens past
    S are w = 1 and zeros.  Every factor is a product of w; nothing is
    divided.  fp32."""
    b, s, h, hd = r.shape
    n = ckpt.shape[2]
    pad = n * every - s

    def spans(x, fill):   # (b, s, h, hd) -> (b, h, n, every, hd)
        x = torch.cat([x.float(), torch.full((b, pad, h, hd), fill,
                                             device=x.device)], 1)
        return x.reshape(b, n, every, h, hd).permute(0, 3, 1, 2, 4)
    rs, ks, vs, ws = (spans(x, f) for x, f in ((r, 0.), (k, 0.), (v, 0.),
                                               (w, 1.)))
    dys = spans(torch.zeros_like(r) if dy is None else dy, 0.)
    sa, gb = ckpt.float(), gck.float()
    m = torch.einsum("bhcxj,bhcyj->bhcxy", dys, vs)
    a = torch.einsum("bhcij,bhctj->bhcti", sa, dys)
    bb = torch.einsum("bhcij,bhctj->bhcti", gb, vs)
    z = (gb * sa).sum(-1)
    uu = u.float()[None, :, None, :]
    U = [None] * every
    U[every - 1] = torch.zeros_like(z)
    for t in range(every - 1, 0, -1):
        U[t - 1] = ws[:, :, :, t] * U[t] + rs[:, :, :, t] * a[:, :, :, t]
    P = [torch.zeros_like(z) for _ in range(every)]
    e, q = torch.ones_like(z), torch.zeros_like(z)
    dr, dk, dw = (torch.empty_like(rs) for _ in range(3))
    for t in range(every):
        kt, rt, wt = ks[:, :, :, t], rs[:, :, :, t], ws[:, :, :, t]
        ct = m[:, :, :, t, t][..., None]
        tt, dkp, dw4 = torch.ones_like(z), torch.zeros_like(z), \
            torch.zeros_like(z)
        for x in range(t + 1, every):
            y = tt * rs[:, :, :, x]
            mv = m[:, :, :, x, t][..., None]
            dkp = dkp + y * mv
            dw4 = dw4 + y * P[x]
            P[x] = wt * P[x] + kt * mv
            tt = tt * ws[:, :, :, x]
        dr[:, :, :, t] = e * a[:, :, :, t] + P[t] + uu * kt * ct
        dk[:, :, :, t] = tt * bb[:, :, :, t] + dkp + uu * rt * ct
        dw[:, :, :, t] = tt * (e * z + q) + e * U[t] + dw4
        q = wt * q + kt * bb[:, :, :, t]
        e = e * wt
    c_all = torch.diagonal(m, dim1=-2, dim2=-1)[..., None]
    du = (rs * ks * c_all).sum((0, 2, 3))

    def back(x):          # (b, h, n, every, hd) -> (b, s, h, hd)
        return x.permute(0, 2, 3, 1, 4).reshape(b, n * every, h, hd)[:, :s]
    return back(dr), back(dk), back(dw), du


def wkv6_bwd_plain(r, k, v, w, u, s0, dy, ds_final, *, ckpt_every: int = 32):
    """The VJP of `wkv6_ref` as the CUDA backward computes it, in fp32.
    dy: (B,S,H,hd) or None, ds_final: (B,H,hd,hd) or None (zeros).  With
    G = dL/dS (the state after token t), G_T = ds_final, walking t from T
    down to 1:
        dr_t = S_{t-1} dy_t + u k_t (dy_t . v_t)
        dk_t = G_t v_t + u r_t (dy_t . v_t)
        dv_t = k_t G_t + dy_t (r_t . u k_t)
        dw_t = rowsum(G_t * S_{t-1})
        du += r_t k_t (dy_t . v_t)
        G_{t-1} = diag(w_t) G_t + r_t^T dy_t,   ds0 = G_0.
    S_{t-1} is recomputed forwards inside each `ckpt_every`-token span from
    the state at the span's start (`wkv6_checkpoints`, as the kernel's),
    never by running the state backwards, which divides by w.  Returns
    (dr, dk, dv, dw, du (H,hd), ds0 (B,H,hd,hd)), all float32."""
    b, s, h, hd = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    dyf = torch.zeros_like(rf) if dy is None else dy.float()
    uf = u.float()
    ckpts = wkv6_checkpoints(k, v, w, s0, ckpt_every)
    g = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
         if ds_final is None else ds_final.float().clone())
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros((b, h, hd), dtype=torch.float32, device=r.device)
    for c in reversed(range(ckpts.shape[2])):
        start, stop = c * ckpt_every, min(s, (c + 1) * ckpt_every)
        hist, st = [], ckpts[:, :, c]
        for t in range(start, stop):
            hist.append(st)
            st = (wf[:, t, :, :, None] * st
                  + kf[:, t, :, :, None] * vf[:, t, :, None, :])
        for t in reversed(range(start, stop)):
            prev = hist[t - start]
            rt, kt, vt, wt, dyt = (x[:, t] for x in (rf, kf, vf, wf, dyf))
            c_t = (dyt * vt).sum(-1, keepdim=True)              # (B,H,1)
            dr[:, t] = (torch.einsum("bhij,bhj->bhi", prev, dyt)
                        + uf * kt * c_t)
            dk[:, t] = torch.einsum("bhij,bhj->bhi", g, vt) + uf * rt * c_t
            dv[:, t] = (torch.einsum("bhi,bhij->bhj", kt, g)
                        + dyt * (rt * uf * kt).sum(-1, keepdim=True))
            dw[:, t] = (g * prev).sum(-1)
            du = du + rt * kt * c_t
            g = wt[..., None] * g + rt[..., None] * dyt[..., None, :]
    return dr, dk, dv, dw, du.sum(0), g


def ssm_checkpoints(dt, u, b, a, h0, every: int):
    """h before tokens 0, every, 2 every, ... of the selective scan
    (`selective_scan.ssm_scan_plain`'s recurrence), in dt's dtype:
    (B,ceil(S/every),D,N), what the CUDA forward writes as its
    checkpoints."""
    bsz, s, di = dt.shape
    u = u.to(dt.dtype)
    h = (torch.zeros((bsz, di, a.shape[-1]), dtype=dt.dtype,
                     device=dt.device) if h0 is None else h0.to(dt.dtype))
    out = []
    for t in range(s):
        if t % every == 0:
            out.append(h)
        h = (torch.exp(dt[:, t, :, None] * a) * h
             + (dt[:, t] * u[:, t])[..., None] * b[:, t, None, :])
    return torch.stack(out, 1)


def ssm_chunk_carry(local, sdt, a, init, reverse: bool = False):
    """The carry that joins the selective scan's chunks, as the CUDA
    kernels run it: `local` (B,nC,D,N) the state each chunk leaves when
    walked from zero (the last chunk walked has none), `sdt` (B,nC,D) each
    chunk's sum of dt, `init` (B,D,N) or None (zeros).  Walking the chunks
    in order (or, `reverse`, from the last), each chunk's slot takes the
    carried state x, then x = exp(a sdt) x + local: the chunk's decay is
    one exp of a sum, at most 1 and never divided by.  Returns (B,nC,D,N):
    h before each chunk (forward) or R after it (reverse)."""
    bsz, nc, di, n = local.shape
    x = (torch.zeros((bsz, di, n), dtype=local.dtype, device=local.device)
         if init is None else init.to(local.dtype))
    out = [None] * nc
    for j in range(nc):
        ck = nc - 1 - j if reverse else j
        out[ck] = x
        if j + 1 < nc:
            x = torch.exp(sdt[:, ck, :, None] * a) * x + local[:, ck]
    return torch.stack(out, 1)


def _ssm_walk(dt, u, b, a, h, lo, hi, c=None):
    """h after tokens lo .. hi - 1 of the forward recurrence from h, and
    with `c` the list of y_t = sum_n h_t C_t."""
    ys = []
    for t in range(lo, hi):
        h = (torch.exp(dt[:, t, :, None] * a) * h
             + (dt[:, t] * u[:, t])[..., None] * b[:, t, None, :])
        if c is not None:
            ys.append((h * c[:, t, None, :]).sum(-1))
    return h, ys


def ssm_scan_chunked(dt, u, b, c, a, h0, chunk: int):
    """The selective scan's forward in the CUDA kernels' order, in dt's
    dtype: each chunk of `chunk` tokens but the last walked from h = 0
    (its state hloc and its sum of dt), `ssm_chunk_carry` for h before each
    chunk, then each chunk walked again from there for y.  dt, u (B,S,D);
    b, c (B,S,N); a (D,N); h0 (B,D,N) or None.  Returns (y (B,S,D), h_last
    (B,D,N)), as `selective_scan.ssm_scan_plain` does."""
    bsz, s, di = dt.shape
    u, b, c, a = (t.to(dt.dtype) for t in (u, b, c, a))
    nc = -(-s // chunk)
    spans = [(k * chunk, min(s, (k + 1) * chunk)) for k in range(nc)]
    zero = torch.zeros((bsz, di, a.shape[-1]), dtype=dt.dtype,
                       device=dt.device)
    local = torch.stack([_ssm_walk(dt, u, b, a, zero, lo, hi)[0]
                         for lo, hi in spans[:-1]] + [zero], 1)
    sdt = torch.stack([dt[:, lo:hi].sum(1) for lo, hi in spans], 1)
    h_in = ssm_chunk_carry(local, sdt, a, h0)
    ys = []
    for k, (lo, hi) in enumerate(spans):
        h, y = _ssm_walk(dt, u, b, a, h_in[:, k], lo, hi, c)
        ys += y
    return torch.stack(ys, 1), h


def ssm_scan_bwd_plain(dt, u, b, c, a, h0, dy, dh_last, *,
                       ckpt_every: int = 16, chunk: int | None = None):
    """The VJP of the selective scan as the CUDA backward computes it, in
    dt's dtype.  dy: (B,S,D) or None, dh_last: (B,D,N) or None (zeros).
    With G_t = dL/dh_t and R = dh_last, walking t from S - 1 down to 0:
        G_t = R + dy_t C_t,   R <- decay_t G_t   (dh0 = R at the end)
        dC_t = sum_d dy_t h_t,   dB_t = sum_d G_t dt_t u_t
        du_t = dt_t sum_n G_t B_t
        ddt_t = u_t sum_n G_t B_t + sum_n G_t h_{t-1} decay_t a
        da = sum_{b,t} G_t h_{t-1} decay_t dt_t
    with decay_t = exp(dt_t a).  h_{t-1} is recomputed forwards inside
    each `ckpt_every`-token span from the state at the span's start
    (`ssm_checkpoints`, as the kernel's), never by dividing by the decay,
    which underflows to 0.  With `chunk` (a multiple of `ckpt_every`), the
    CUDA kernels' order: each chunk but the first walked back from R = 0,
    the reverse carry (`ssm_chunk_carry`) from dh_last for R at the end of
    each chunk, then each chunk walked back from there.  Returns (ddt, du
    (B,S,D), db, dc (B,S,N), da (D,N), dh0 (B,D,N))."""
    bsz, s, di = dt.shape
    f = dt.dtype
    u, b, c, a = (t.to(f) for t in (u, b, c, a))
    dy = torch.zeros_like(dt) if dy is None else dy.to(f)
    ckpts = ssm_checkpoints(dt, u, b, a, h0, ckpt_every)
    g = (torch.zeros((bsz, di, a.shape[-1]), dtype=f, device=dt.device)
         if dh_last is None else dh_last.to(f).clone())
    r_out = {}
    if chunk is not None:
        if chunk % ckpt_every:
            raise ValueError(f"chunk {chunk} is not a multiple of "
                             f"ckpt_every {ckpt_every}")
        r_out = _ssm_reverse_carry(dt, c, a, dy, g, chunk)
    ddt, du = torch.empty_like(dt), torch.empty_like(dt)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da = torch.zeros_like(a)
    for ck in reversed(range(ckpts.shape[1])):
        start, stop = ck * ckpt_every, min(s, (ck + 1) * ckpt_every)
        g = r_out.get(stop, g)
        hist = [ckpts[:, ck]]
        for t in range(start, stop):
            hist.append(torch.exp(dt[:, t, :, None] * a) * hist[-1]
                        + (dt[:, t] * u[:, t])[..., None] * b[:, t, None, :])
        for t in reversed(range(start, stop)):
            dtt, ut, dyt = dt[:, t], u[:, t], dy[:, t]
            dec = torch.exp(dtt[..., None] * a)
            gt = g + dyt[..., None] * c[:, t, None, :]
            dc[:, t] = (dyt[..., None] * hist[t - start + 1]).sum(1)
            db[:, t] = (gt * (dtt * ut)[..., None]).sum(1)
            gb = (gt * b[:, t, None, :]).sum(-1)
            ghd = gt * hist[t - start] * dec
            du[:, t] = dtt * gb
            ddt[:, t] = ut * gb + (ghd * a).sum(-1)
            da = da + (ghd * dtt[..., None]).sum(0)
            g = dec * gt
    return ddt, du, db, dc, da, g


def _ssm_reverse_carry(dt, c, a, dy, dh_last, chunk: int) -> dict:
    """{the token after each chunk: R there} by the reverse carry: each
    chunk but the first walked back from R = 0 (R = decay (R + dy C)),
    then `ssm_chunk_carry` from dh_last."""
    bsz, s, di = dt.shape
    nc = -(-s // chunk)
    spans = [(k * chunk, min(s, (k + 1) * chunk)) for k in range(nc)]
    zero = torch.zeros_like(dh_last)
    local = []
    for lo, hi in spans[1:]:
        r = zero
        for t in reversed(range(lo, hi)):
            r = torch.exp(dt[:, t, :, None] * a) * (
                r + dy[:, t, :, None] * c[:, t, None, :])
        local.append(r)
    sdt = torch.stack([dt[:, lo:hi].sum(1) for lo, hi in spans], 1)
    r_out = ssm_chunk_carry(torch.stack([zero] + local, 1), sdt, a, dh_last,
                            reverse=True)
    return {hi: r_out[:, k] for k, (_, hi) in enumerate(spans)}

