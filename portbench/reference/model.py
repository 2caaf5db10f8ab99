"""Forward pass, loss and last-position logits of a dense or DeepSeek-MoE
decoder, in float32, over the params layout of `portbench.weights`.

`prec` picks the precision of the linear layers' products: "fp32" is the
reference; "fp8" is the control, each operand rounded to float8 e4m3 with
one scale a tensor (amax / 448) before an fp32 product, the step a later
change could be tempted to take.  Norms, RoPE, softmax, attention and the
loss stay in float32 in both.

Conventions (the port's, which the configuration files state): rmsnorm
x / sqrt(mean(x^2) + eps) x scale; RoPE on the two halves of each head,
frequencies theta^(-2i/hd); causal softmax at hd^-0.5; SwiGLU; residual
branches times `residual_scale`; an untied or tied unembedding; the loss is
the mean of logsumexp - logit[label] + z_loss logsumexp^2.  The MoE routes
as the port defines it: tokens flattened row-major into groups of
`group_size`, softmax router probabilities (plus the router bias for the
choice), top-k by a stable descending sort, gates renormalised over the k,
each (token, slot) pair given the count of the group's earlier pairs on
the same expert, token-major, and dropped from `capacity` on; the shared
experts are one SwiGLU of n_shared x d_expert.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

PRECISIONS = ("fp32", "fp8")
FP8_MAX = 448.0


def strict_fp32() -> None:
    """No TF32 anywhere: float32 products are float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, prec: str, n_in: int = 1):
    """x's last `n_in` dims contracted with w's first `n_in` dims, fp32."""
    lead, out = x.shape[:x.dim() - n_in], w.shape[n_in:]
    a = x.reshape(-1, math.prod(x.shape[x.dim() - n_in:])).float()
    b = w.reshape(a.shape[1], -1).float()
    if prec == "fp8":
        a, b = _fp8(a), _fp8(b)
    return (a @ b).reshape(*lead, *out)


def capacity(moe: dict) -> int:
    return int(moe["group_size"] * moe["top_k"] / moe["n_experts"]
               * moe["capacity_factor"]) + 1


class Reference:
    def __init__(self, cfg: dict, prec: str = "fp32"):
        if prec not in PRECISIONS:
            raise ValueError(f"prec={prec!r} not in {PRECISIONS}")
        self.cfg, self.prec = cfg, prec
        self.eps = cfg.get("rms_eps", 1e-6)
        self.rs = cfg.get("residual_scale", 1.0)

    # -- layers ------------------------------------------------------------
    def rmsnorm(self, scale, x):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) \
            * scale.float()

    def rope(self, x, positions):
        hd = x.shape[-1]
        freqs = 1.0 / (self.cfg["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
        ang = positions.float()[:, None] * freqs
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, p, x, positions):
        cfg = self.cfg
        h, kvh = cfg["n_heads"], cfg["n_kv_heads"]
        q = linear(x, p["wq"], self.prec)
        k = linear(x, p["wk"], self.prec)
        v = linear(x, p["wv"], self.prec)
        if cfg.get("qk_norm"):
            q = self.rmsnorm(p["q_norm"]["scale"], q)
            k = self.rmsnorm(p["k_norm"]["scale"], k)
        q, k = self.rope(q, positions), self.rope(k, positions)
        if kvh != h:
            k = k.repeat_interleave(h // kvh, dim=-2)
            v = v.repeat_interleave(h // kvh, dim=-2)
        s = x.shape[1]
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        outs = []
        for i in range(x.shape[0]):   # one sequence at a time: (H, S, S)
            logits = torch.einsum("qhd,khd->hqk", q[i], k[i]) \
                * q.shape[-1] ** -0.5
            probs = torch.softmax(logits.masked_fill(~mask, -math.inf), -1)
            outs.append(torch.einsum("hqk,khd->qhd", probs, v[i]))
        return linear(torch.stack(outs), p["wo"], self.prec, n_in=2)

    def mlp(self, p, x):
        gate = F.silu(linear(x, p["wi_gate"], self.prec))
        return linear(gate * linear(x, p["wi_up"], self.prec), p["wo"],
                      self.prec)

    def moe(self, p, x):
        m = self.cfg["moe"]
        b, s, d = x.shape
        e, k, g = m["n_experts"], m["top_k"], m["group_size"]
        flat = x.reshape(b * s, d)
        n = flat.shape[0]
        pad = (-n) % g
        rows = torch.cat([flat, flat.new_zeros(pad, d)]) if pad else flat
        valid = torch.arange(n + pad, device=x.device) < n
        probs = torch.softmax(linear(rows, p["router"], self.prec), -1)
        choice = probs + p["router_bias"].float() if "router_bias" in p \
            else probs
        expert = torch.sort(choice, dim=-1, descending=True,
                            stable=True).indices[:, :k]        # (T, K)
        gates = probs.gather(-1, expert)
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
        # position of each (token, slot) among its group's pairs on that
        # expert, token-major
        n_g = rows.shape[0] // g
        pair_valid = valid.reshape(n_g, g).repeat_interleave(k, dim=1)
        onehot = F.one_hot(expert.reshape(n_g, g * k), e) * pair_valid[
            ..., None]
        pos = (onehot.cumsum(1) * onehot).sum(-1) - 1           # (G, g*K)
        kept = (pos < capacity(m)) & pair_valid
        kept = kept.reshape(-1, k)
        out = torch.zeros_like(rows)
        for j in range(e):
            tok, slot = torch.nonzero((expert == j) & kept, as_tuple=True)
            if tok.numel() == 0:
                continue
            h_in = rows[tok]
            gate = F.silu(linear(h_in, p["wi_gate"][j], self.prec))
            y = linear(gate * linear(h_in, p["wi_up"][j], self.prec),
                       p["wo"][j], self.prec)
            out.index_add_(0, tok, y * gates[tok, slot][:, None])
        out = out[:n].reshape(b, s, d)
        if "shared" in p:
            out = out + self.mlp(p["shared"], x)
        return out

    def block(self, lp, kind, x, positions):
        h = self.rmsnorm(lp["ln_attn"]["scale"], x)
        x = x + self.attention(lp["attn"], h, positions) * self.rs
        h = self.rmsnorm(lp["ln_mlp"]["scale"], x)
        f = self.moe(lp["ffn"], h) if kind == "moe" else self.mlp(lp["ffn"], h)
        return x + f * self.rs

    # -- model -------------------------------------------------------------
    def hidden(self, params, tokens, remat: bool = False):
        """Final-normed hidden states (B, S, d), fp32."""
        from portbench.weights import segments
        x = params["embed"]["table"][tokens].float()
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for i, (kind, _) in enumerate(segments(self.cfg)):
            for lp in params[f"seg{i}"]:
                if remat:
                    x = ckpt.checkpoint(self.block, lp, kind, x, positions,
                                        use_reentrant=False)
                else:
                    x = self.block(lp, kind, x, positions)
        return self.rmsnorm(params["ln_f"]["scale"], x)

    def unembed_weight(self, params):
        emb = params["embed"]
        return emb["table"].T if "unembed" not in emb else emb["unembed"]

    def logits(self, params, h):
        return linear(h, self.unembed_weight(params), self.prec)

    @torch.no_grad()
    def last_logits(self, params, tokens):
        """(B, V) fp32 logits of each sequence's last position."""
        return self.logits(params, self.hidden(params, tokens)[:, -1])

    def _ce(self, h, w, labels, z_loss):
        logits = linear(h, w, self.prec)
        logz = torch.logsumexp(logits, -1)
        ll = logits.gather(-1, labels[:, None])[:, 0]
        return (logz - ll + z_loss * logz.square()).sum()

    def loss(self, params, tokens, labels, chunk: int = 2048):
        """Mean next-token cross-entropy with z-loss; blocks recomputed in
        the backward and the unembedding taken `chunk` rows at a time, so
        that float32 training fits beside nothing else on one card."""
        z = self.cfg.get("loss", {}).get("z_loss", 1e-4)
        h = self.hidden(params, tokens, remat=True)
        h = h.reshape(-1, h.shape[-1])
        lab = labels.reshape(-1)
        w = self.unembed_weight(params)
        total = 0.0
        for i in range(0, h.shape[0], chunk):
            total = total + ckpt.checkpoint(self._ce, h[i:i + chunk], w,
                                            lab[i:i + chunk], z,
                                            use_reentrant=False)
        return total / h.shape[0]
