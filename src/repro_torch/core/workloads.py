"""Workload descriptors — paper Table III CNNs + LM workload adapter.

The architecture-level analyses need, per workload, the layer-by-layer
tensor dimensions from which the traffic model (core/traffic.py) derives L2
read/write transactions, DRAM reuse behavior, and compute time.  The paper
profiles Caffe on a 1080 Ti; we reconstruct the same quantities from the
published layer configurations (the Caffe execution model is encoded in
traffic.py: conv layers loop images with a shared im2col buffer, fc layers
run one batched GEMM).

The five CNNs reproduce paper Table III within a few percent (validated in
tests/test_workloads.py).  `lm_workload` adapts an assigned LM architecture
config into the same representation, which is how the DeepNVM++ pipeline is
applied to the JAX framework's own workloads (DESIGN.md §2).
"""

from __future__ import annotations

import dataclasses
import functools

DTYPE_BYTES = 4  # Caffe fp32


@dataclasses.dataclass(frozen=True)
class Layer:
    """One macro layer: convolution or fully-connected (GEMM)."""

    name: str
    kind: str          # "conv" | "fc"
    cin: int
    cout: int
    k: int             # kernel size (1 for fc)
    hout: int          # output spatial (1 for fc)
    wout: int
    hin: int
    win: int
    groups: int = 1

    @property
    def macs(self) -> int:
        return self.cout * (self.cin // self.groups) * self.k * self.k \
            * self.hout * self.wout

    @property
    def params(self) -> int:
        return self.cout * (self.cin // self.groups) * self.k * self.k

    @property
    def weight_bytes(self) -> int:
        return self.params * DTYPE_BYTES

    @property
    def act_in_bytes(self) -> int:
        return self.cin * self.hin * self.win * DTYPE_BYTES

    @property
    def act_out_bytes(self) -> int:
        return self.cout * self.hout * self.wout * DTYPE_BYTES

    @property
    def im2col_bytes(self) -> int:
        """Caffe's unfolded input buffer (conv only; 1x1 convs skip it)."""
        if self.kind != "conv" or self.k == 1:
            return 0
        return self.cin * self.k * self.k * self.hout * self.wout * DTYPE_BYTES


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    layers: tuple[Layer, ...]
    top5_error: float = 0.0

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)

    @property
    def total_params(self) -> int:
        return sum(l.params for l in self.layers)

    @property
    def conv_layers(self) -> int:
        return sum(1 for l in self.layers if l.kind == "conv")

    @property
    def fc_layers(self) -> int:
        return sum(1 for l in self.layers if l.kind == "fc")


def _conv(name, cin, cout, k, hin, stride=1, groups=1, pad=None, win=None):
    win = hin if win is None else win
    pad = k // 2 if pad is None else pad
    hout = (hin + 2 * pad - k) // stride + 1
    wout = (win + 2 * pad - k) // stride + 1
    return Layer(name, "conv", cin, cout, k, hout, wout, hin, win, groups)


def _fc(name, cin, cout):
    return Layer(name, "fc", cin, cout, 1, 1, 1, 1, 1)


# ---------------------------------------------------------------------------
# Table III networks
# ---------------------------------------------------------------------------


def alexnet() -> Workload:
    ls = [
        _conv("conv1", 3, 96, 11, 227, stride=4, pad=0),   # 55x55
        _conv("conv2", 96, 256, 5, 27, groups=2),          # 27x27 (post-pool)
        _conv("conv3", 256, 384, 3, 13),
        _conv("conv4", 384, 384, 3, 13, groups=2),
        _conv("conv5", 384, 256, 3, 13, groups=2),
        _fc("fc6", 9216, 4096),
        _fc("fc7", 4096, 4096),
        _fc("fc8", 4096, 1000),
    ]
    return Workload("alexnet", tuple(ls), top5_error=16.4)


def vgg16() -> Workload:
    ls, h, cin = [], 224, 3
    for i, (cout, reps) in enumerate([(64, 2), (128, 2), (256, 3),
                                      (512, 3), (512, 3)]):
        for r in range(reps):
            ls.append(_conv(f"conv{i + 1}_{r + 1}", cin, cout, 3, h))
            cin = cout
        h //= 2
    ls += [_fc("fc6", 25088, 4096), _fc("fc7", 4096, 4096),
           _fc("fc8", 4096, 1000)]
    return Workload("vgg16", tuple(ls), top5_error=7.3)


def resnet18() -> Workload:
    ls = [_conv("conv1", 3, 64, 7, 224, stride=2)]  # 112x112 (pool -> 56)
    h, cin = 56, 64
    for stage, cout in enumerate([64, 128, 256, 512]):
        for block in range(2):
            stride = 2 if (stage > 0 and block == 0) else 1
            hout = h // stride
            ls.append(_conv(f"s{stage}b{block}c1", cin, cout, 3, h, stride=stride))
            ls.append(_conv(f"s{stage}b{block}c2", cout, cout, 3, hout))
            if stride == 2 or cin != cout:
                ls.append(_conv(f"s{stage}b{block}ds", cin, cout, 1, h,
                                stride=stride, pad=0))
            cin, h = cout, hout
    ls.append(_fc("fc", 512, 1000))
    return Workload("resnet18", tuple(ls), top5_error=10.71)


def squeezenet() -> Workload:
    # SqueezeNet v1.0: conv1 + 8 fire modules (3 convs each) + conv10 = 26.
    def fire(name, cin, s1, e1, e3, h):
        return [
            _conv(f"{name}.s1", cin, s1, 1, h, pad=0),
            _conv(f"{name}.e1", s1, e1, 1, h, pad=0),
            _conv(f"{name}.e3", s1, e3, 3, h),
        ]

    ls = [_conv("conv1", 3, 96, 7, 224, stride=2, pad=0)]  # 109 -> pool 54
    ls += fire("fire2", 96, 16, 64, 64, 54)
    ls += fire("fire3", 128, 16, 64, 64, 54)
    ls += fire("fire4", 128, 32, 128, 128, 54)
    ls += fire("fire5", 256, 32, 128, 128, 27)   # post-pool
    ls += fire("fire6", 256, 48, 192, 192, 27)
    ls += fire("fire7", 384, 48, 192, 192, 27)
    ls += fire("fire8", 384, 64, 256, 256, 27)
    ls += fire("fire9", 512, 64, 256, 256, 13)   # post-pool
    ls.append(_conv("conv10", 512, 1000, 1, 13, pad=0))
    return Workload("squeezenet", tuple(ls), top5_error=16.4)


def googlenet() -> Workload:
    # Inception v1 (57 convs, 1 fc).
    def inception(name, cin, n1, r3, n3, r5, n5, pp, h):
        return [
            _conv(f"{name}.1x1", cin, n1, 1, h, pad=0),
            _conv(f"{name}.3r", cin, r3, 1, h, pad=0),
            _conv(f"{name}.3x3", r3, n3, 3, h),
            _conv(f"{name}.5r", cin, r5, 1, h, pad=0),
            _conv(f"{name}.5x5", r5, n5, 5, h),
            _conv(f"{name}.pp", cin, pp, 1, h, pad=0),
        ]

    ls = [
        _conv("conv1", 3, 64, 7, 224, stride=2),      # 112
        _conv("conv2r", 64, 64, 1, 56, pad=0),        # post-pool
        _conv("conv2", 64, 192, 3, 56),
    ]
    ls += inception("3a", 192, 64, 96, 128, 16, 32, 32, 28)
    ls += inception("3b", 256, 128, 128, 192, 32, 96, 64, 28)
    ls += inception("4a", 480, 192, 96, 208, 16, 48, 64, 14)
    ls += inception("4b", 512, 160, 112, 224, 24, 64, 64, 14)
    ls += inception("4c", 512, 128, 128, 256, 24, 64, 64, 14)
    ls += inception("4d", 512, 112, 144, 288, 32, 64, 64, 14)
    ls += inception("4e", 528, 256, 160, 320, 32, 128, 128, 14)
    ls += inception("5a", 832, 256, 160, 320, 32, 128, 128, 7)
    ls += inception("5b", 832, 384, 192, 384, 48, 128, 128, 7)
    ls.append(_fc("fc", 1024, 1000))
    return Workload("googlenet", tuple(ls), top5_error=6.7)


def paper_workloads() -> dict[str, Workload]:
    """The five DNNs of paper Table III, in figure order."""
    return {w.name: w for w in
            (alexnet(), googlenet(), vgg16(), resnet18(), squeezenet())}


@functools.lru_cache(maxsize=None)
def registry() -> dict[str, Workload]:
    """The CNN side of the unified scenario namespace ("cnn/<name>/...",
    repro_torch.scenarios): every named workload the traffic model knows.
    Currently the paper Table III networks; new entries extend the
    symbolic-spec vocabulary without touching the resolver."""
    return paper_workloads()


def get(name: str) -> Workload:
    """Resolve a workload by registry name (symbolic-spec resolution)."""
    try:
        return registry()[name]
    except KeyError:
        raise ValueError(f"unknown workload {name!r}; available: "
                         f"{sorted(registry())}") from None


# Reference values from paper Table III for validation.
TABLE3 = {
    "alexnet": dict(macs=724e6, params=61e6, conv=5, fc=3),
    "googlenet": dict(macs=1.43e9, params=7e6, conv=57, fc=1),
    "vgg16": dict(macs=15.5e9, params=138e6, conv=13, fc=3),
    "resnet18": dict(macs=2e9, params=11.8e6, conv=17, fc=1),
    "squeezenet": dict(macs=837e6, params=1.2e6, conv=26, fc=0),
}


# ---------------------------------------------------------------------------
# LM workload adapter (framework tie-in; beyond-paper)
# ---------------------------------------------------------------------------


def lm_workload(name: str, *, n_layers: int, d_model: int, d_ff: int,
                n_heads: int, n_kv_heads: int, head_dim: int, vocab: int,
                seq_len: int, n_experts: int = 0, top_k: int = 0,
                d_expert: int = 0, dtype_bytes: int = 2) -> Workload:
    """Represent one transformer layer stack as GEMM (fc) macro-layers per
    token batch, so the same traffic pipeline applies to LM workloads.

    Each attention/MLP projection becomes an fc layer with the token batch
    folded into the caller's `batch` argument of the traffic model; MoE
    layers contribute their active experts (6*N_active*D compute model).
    """
    del dtype_bytes  # L2 traffic model fixes fp32; LMs rescale via bytes
    q_dim = n_heads * head_dim
    kv_dim = n_kv_heads * head_dim
    ls: list[Layer] = []
    for i in range(n_layers):
        ls += [
            _fc(f"l{i}.q", d_model, q_dim),
            _fc(f"l{i}.k", d_model, kv_dim),
            _fc(f"l{i}.v", d_model, kv_dim),
            _fc(f"l{i}.o", q_dim, d_model),
        ]
        if n_experts:
            for e in range(top_k):
                ls += [_fc(f"l{i}.e{e}.up", d_model, 2 * d_expert),
                       _fc(f"l{i}.e{e}.down", d_expert, d_model)]
        else:
            ls += [_fc(f"l{i}.up", d_model, 2 * d_ff),
                   _fc(f"l{i}.down", d_ff, d_model)]
    ls.append(_fc("lm_head", d_model, vocab))
    # attention score/context GEMMs: seq-dependent, modeled as one fc whose
    # "weights" are the KV cache of one sequence
    ls.append(_fc("attn_sdpa", seq_len * 2, n_layers * kv_dim))
    return Workload(f"lm:{name}", tuple(ls))
