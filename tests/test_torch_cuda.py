"""The CUDA flash-attention kernel against its plain twin, on the GPU.

Marked `cuda`: each test skips without a CUDA device.  Run on the GPU
machine with `PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py`.
This file imports no JAX (the GPU machine has none).
"""

import pytest
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import lm

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, b, sq, h, hd, dtype, skv=None, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    return tuple(torch.randn(b, s, h, hd, generator=g, device=dev).to(dtype)
                 for s in (sq, skv or sq, skv or sq))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal,window,q_offset,scale,sq,skv", [
    (True, None, 0, None, 256, 256),
    (False, None, 0, None, 256, 256),
    (True, 128, 0, None, 512, 512),
    (True, None, 128, None, 128, 256),
    (False, None, 0, 0.3, 200, 333),
    (True, None, 0, None, 2100, 2100),
])
def test_kernel_matches_plain(dev, dtype, hd, causal, window, q_offset,
                              scale, sq, skv):
    q, k, v = _qkv(dev, 2, sq, 3, hd, dtype, skv)
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, scale=scale)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


def test_kernel_reads_strided_q(dev):
    q, k, v = _qkv(dev, 1, 256, 2, 64, torch.bfloat16)
    got = fa.flash_attention(q[:, 128:], k, v, q_offset=128)
    want = fa.flash_attention_plain(q[:, 128:], k, v, q_offset=128)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


def test_kernel_rejects_unsupported_head_dim(dev):
    q, k, v = _qkv(dev, 1, 64, 1, 32, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, k, v)


def test_model_prefill_launches_one_kernel_per_layer(dev):
    cfg = ArchConfig(name="gpu-test", family="dense", n_layers=2, d_model=256,
                     n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
                     vocab=512)
    params = lm.build(cfg).init(torch.Generator(dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (1, ops.FLASH_THRESHOLD),
                           device=dev)
    before = fa.flash_attention.launches
    got = lm.build(cfg).prefill(params, tokens,
                                lm.build(cfg).init_cache(1, 2048, dev))
    assert fa.flash_attention.launches - before == cfg.n_layers
    plain = lm.build(cfg, attn_force="plain")
    want = plain.prefill(params, tokens, plain.init_cache(1, 2048, dev))
    rel = (got - want).abs().max() / want.abs().max()
    assert rel.item() <= 2e-2
