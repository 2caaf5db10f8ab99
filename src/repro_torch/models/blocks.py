"""RWKV6 (Finch) blocks, ported from `repro.models.blocks`: the time-mix
with its data-dependent decay, and the channel-mix.

Storage follows `layers`: matmul weights and the `mu_*` token-shift mixes
in bf16 for serving (the JAX package casts them to the activation dtype at
every use) or in the init's `dtype` (fp32 masters for training), while the
leaves that the JAX time-mix reads in fp32 stay fp32: the decay
base `w0`, its LoRA `w_lora_a` / `w_lora_b` and the bonus `u`.

The WKV recurrence goes through `ops.rwkv_mix` (the CUDA kernel on the GPU)
where the JAX block runs its own `lax.scan`.  As in the JAX package, the
state handed back between calls (`last_x` and the WKV state `s`) is bf16.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.layers import Params, _matmul


@dataclasses.dataclass(frozen=True)
class RWKVDims:
    d_model: int
    n_heads: int           # head_dim = d_model // n_heads
    d_ff: int
    decay_lora: int = 64

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init_rwkv_tmix(generator: torch.Generator, dims: RWKVDims,
                   dtype=torch.bfloat16) -> Params:
    d, dev = dims.d_model, generator.device
    s = d ** -0.5
    tn = layers.truncated_normal

    def mix():
        return torch.full((d,), 0.5, dtype=dtype, device=dev)
    return {
        "mu_r": mix(), "mu_k": mix(), "mu_v": mix(), "mu_w": mix(),
        "wr": tn((d, d), s, generator, dtype),
        "wk": tn((d, d), s, generator, dtype),
        "wv": tn((d, d), s, generator, dtype),
        "wg": tn((d, d), s, generator, dtype),
        "w0": torch.full((d,), -5.0, dtype=torch.float32, device=dev),
        "w_lora_a": tn((d, dims.decay_lora), s, generator, torch.float32),
        "w_lora_b": tn((dims.decay_lora, d), dims.decay_lora ** -0.5,
                       generator, torch.float32),
        "bonus": torch.zeros((dims.n_heads, dims.head_dim),
                             dtype=torch.float32, device=dev),
        "ln_out": layers.init_rmsnorm(d, dev),
        "wo": tn((d, d), s, generator, dtype),
    }


def _shifted(x: torch.Tensor, state: Params | None) -> torch.Tensor:
    """x moved one token later; position 0 gets the carried `last_x`."""
    last = (torch.zeros_like(x[:, 0]) if state is None
            else state["last_x"].to(x.dtype))
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def rwkv_tmix(p: Params, dims: RWKVDims, x: torch.Tensor, *,
              state: Params | None = None, force: str | None = None):
    """WKV6 time-mix.  x: (B,S,d); state: {"last_x": (B,d),
    "s": (B,H,hd,hd)} or None.  `force` goes to `ops.rwkv_mix`.
    Returns (out, new_state), the state in bf16."""
    b, s_len, d = x.shape
    h, hd = dims.n_heads, dims.head_dim
    x_prev = _shifted(x, state)

    def mix(mu):
        return x + (x_prev - x) * mu.to(x.dtype)

    r = _matmul(mix(p["mu_r"]), p["wr"])
    k = _matmul(mix(p["mu_k"]), p["wk"])
    v = _matmul(mix(p["mu_v"]), p["wv"])
    g = F.silu(_matmul(x, p["wg"]))
    # data-dependent decay, in fp32
    w_in = mix(p["mu_w"]).float()
    w = p["w0"] + (w_in @ p["w_lora_a"]) @ p["w_lora_b"]
    w = torch.exp(-torch.exp(w))

    heads = (b, s_len, h, hd)
    y, s_last = ops.rwkv_mix(
        r.reshape(heads).float(), k.reshape(heads).float(),
        v.reshape(heads).float(), w.reshape(heads), p["bonus"],
        s0=None if state is None else state["s"].float(), force=force)
    y = y.reshape(b, s_len, d).to(x.dtype)
    y = layers.rmsnorm(p["ln_out"], y) * g
    out = _matmul(y, p["wo"])
    return out, {"last_x": x[:, -1].to(torch.bfloat16),
                 "s": s_last.to(torch.bfloat16)}


def init_rwkv_cmix(generator: torch.Generator, dims: RWKVDims,
                   dtype=torch.bfloat16) -> Params:
    d = dims.d_model
    return {
        "mu": torch.full((d,), 0.5, dtype=dtype, device=generator.device),
        "wk": layers.truncated_normal((d, dims.d_ff), d ** -0.5, generator,
                                      dtype),
        "wv": layers.truncated_normal((dims.d_ff, d), dims.d_ff ** -0.5,
                                      generator, dtype),
    }


def rwkv_cmix(p: Params, dims: RWKVDims, x: torch.Tensor, *,
              state: Params | None = None):
    """Squared-ReLU channel-mix with token shift.  Returns (out,
    {"last_x": (B,d) bf16})."""
    xm = x + (_shifted(x, state) - x) * p["mu"].to(x.dtype)
    k = torch.square(torch.relu(_matmul(xm, p["wk"])))
    return (_matmul(k, p["wv"]),
            {"last_x": x[:, -1].to(torch.bfloat16)})


def init_rwkv_state(batch: int, dims: RWKVDims, device) -> Params:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16, device=device)
    return {"tmix": {"last_x": z(batch, dims.d_model),
                     "s": z(batch, dims.n_heads, dims.head_dim,
                            dims.head_dim)},
            "cmix": {"last_x": z(batch, dims.d_model)}}
