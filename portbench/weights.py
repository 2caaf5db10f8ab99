"""Weights made on the device from `--seed`, in the dtype they are run in,
laid out as the port's `LM` takes its params (nested dicts; a segment is a
list of per-layer dicts).

Each kind of leaf is drawn for all the layers of its segment in one call
and split into per-layer views: matrices N(0, 1) x fan_in^-0.5, the
embedding table and unembedding N(0, 1) x d^-0.5, norm scales 1 + 0.1
N(0, 1) in float32, the MoE router bias zero in float32.  The same seed on
the same device gives the same weights, so the reference draws them again
rather than read the program's."""

from __future__ import annotations

import sys

import torch

# leaves kept in float32 whatever the matrices' dtype
_NORM, _ZERO = "norm", "zero"


def segments(cfg: dict) -> list[tuple[str, int]]:
    """(kind, layers) of each segment, in the port's `layer_plan` order."""
    moe = cfg.get("moe")
    if moe is None:
        return [("dense", cfg["n_layers"])]
    lead = moe["first_dense_layers"]
    return ([("dense_lead", lead)] if lead else []) + [
        ("moe", cfg["n_layers"] - lead)]


def block_layout(cfg: dict, kind: str) -> dict:
    """{path: (shape, fan_in or a leaf kind)} of one block."""
    d, h, kv, hd = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                    cfg["head_dim"])
    out = {"ln_attn.scale": ((d,), _NORM), "ln_mlp.scale": ((d,), _NORM),
           "attn.wq": ((d, h, hd), d), "attn.wk": ((d, kv, hd), d),
           "attn.wv": ((d, kv, hd), d), "attn.wo": ((h, hd, d), h * hd)}
    if cfg.get("qk_norm"):
        out["attn.q_norm.scale"] = ((hd,), _NORM)
        out["attn.k_norm.scale"] = ((hd,), _NORM)
    if kind == "moe":
        m = cfg["moe"]
        e, f = m["n_experts"], m["d_expert"]
        out.update({"ffn.router": ((d, e), d),
                    "ffn.wi_gate": ((e, d, f), d), "ffn.wi_up": ((e, d, f), d),
                    "ffn.wo": ((e, f, d), f)})
        if m.get("router_bias", True):
            out["ffn.router_bias"] = ((e,), _ZERO)
        if m["n_shared"]:
            fs = m["n_shared"] * f
            out.update({"ffn.shared.wi_gate": ((d, fs), d),
                        "ffn.shared.wi_up": ((d, fs), d),
                        "ffn.shared.wo": ((fs, d), fs)})
    else:
        ff = cfg["moe"]["dense_d_ff"] if kind == "dense_lead" else cfg["d_ff"]
        out.update({"ffn.wi_gate": ((d, ff), d), "ffn.wi_up": ((d, ff), d),
                    "ffn.wo": ((ff, d), ff)})
    return out


def _put(tree: dict, path: str, value) -> None:
    *parents, leaf = path.split(".")
    for key in parents:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


def _draw(gen: torch.Generator, shape, spec, dtype) -> torch.Tensor:
    if spec == _ZERO:
        return torch.zeros(shape, dtype=torch.float32, device=gen.device)
    if spec == _NORM:
        t = torch.randn(shape, dtype=torch.float32, device=gen.device,
                        generator=gen)
        return t.mul_(0.1).add_(1.0)
    t = torch.randn(shape, dtype=dtype, device=gen.device, generator=gen)
    return t.mul_(spec ** -0.5)


def make(cfg: dict, seed: int, device, dtype, arch=None) -> dict:
    """The params, matrices in `dtype`, drawn from `seed` on `device`, in
    the layout of `arch` (the cell's architecture module, `spec.arch`; the
    decoder's, this module's own, where None)."""
    arch = arch or sys.modules[__name__]
    gen = torch.Generator(device).manual_seed(seed)
    d, v = cfg["d_model"], cfg["vocab"]
    params: dict = {"embed": {"table": _draw(gen, (v, d), d, dtype)}}
    if not cfg["tied_embeddings"]:
        params["embed"]["unembed"] = _draw(gen, (d, v), d, dtype)
    params["ln_f"] = {"scale": _draw(gen, (d,), _NORM, dtype)}
    for i, (kind, count) in enumerate(arch.segments(cfg)):
        blocks: list[dict] = [{} for _ in range(count)]
        for path, (shape, spec) in arch.block_layout(cfg, kind).items():
            stacked = _draw(gen, (count, *shape), spec, dtype)
            for blk, leaf in zip(blocks, stacked.unbind(0)):
                _put(blk, path, leaf)
        params[f"seg{i}"] = blocks
    return params


def names(cfg: dict, arch=None) -> list[str]:
    """The leaves' paths in `leaves(make(cfg, ..., arch))` order, nothing
    drawn."""
    arch = arch or sys.modules[__name__]
    out = ["embed.table"] + ([] if cfg["tied_embeddings"]
                             else ["embed.unembed"]) + ["ln_f.scale"]
    for i, (kind, count) in enumerate(arch.segments(cfg)):
        layout = arch.block_layout(cfg, kind)
        out += [f"seg{i}.{j}.{path}" for j in range(count) for path in layout]
    return out


def leaves(params: dict, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) of every leaf, in insertion order."""
    out = []
    items = (params.items() if isinstance(params, dict)
             else ((str(i), x) for i, x in enumerate(params)))
    for key, x in items:
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(x, (dict, list)):
            out.extend(leaves(x, path))
        else:
            out.append((path, x))
    return out
