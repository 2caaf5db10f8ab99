"""The port's LM and serving path against `repro.models.lm` and
`repro.launch.serve` on reduced configs.

Params come from the JAX `model.init` and cross with `params_from_jax`;
tokens come from a numpy seed.  Bars: forward and prefill logits within
2e-2 of the largest magnitude, teacher-forced decode steps within 3e-2
(the bar tests/test_models.py uses for decode against forward).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import lm as jlm
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import lm as tlm

DENSE = ["tinyllama-1.1b", "qwen3-14b", "gemma-7b", "minicpm-2b",
         "chameleon-34b"]


# Gemma-7B's block at head dim 256, narrow and shallow: GeGLU, tied
# embeddings, sqrt(d) embedding scale and logit cap 30 from its reduced
# config, two heads of 256
GEMMA_HD256 = dict(name="gemma-hd256-smoke", n_layers=2, d_model=512,
                   n_heads=2, n_kv_heads=2, head_dim=256, d_ff=1024,
                   vocab=512)


def _config(package, arch):
    """`arch`'s reduced config from `package` (the JAX or the port's
    configs), or the Gemma-shaped hd-256 config for "gemma-hd256"."""
    if arch == "gemma-hd256":
        return dataclasses.replace(package.get("gemma-7b", reduced=True),
                                   **GEMMA_HD256)
    return package.get(arch, reduced=True)


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX model, JAX params, port model, port params) for a reduced
    config; read-only, shared across tests."""
    jm = jlm.build(_config(jconfigs, arch))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = tlm.build(_config(tconfigs, arch))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _rel(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(1e-6, np.abs(want).max())


def test_configs_are_copies():
    for arch in jconfigs.all_archs():
        j = jconfigs.get(arch)
        t = tconfigs.get(arch)
        assert type(t).__module__.startswith("repro_torch.")
        assert repr(j) == repr(t)
        assert repr(jconfigs.get(arch, reduced=True)) == repr(
            tconfigs.get(arch, reduced=True))


@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_match_jax(arch):
    jm, jp, tm, tp = _models(arch)
    tokens = _tokens((2, 32), tm.cfg.vocab)
    want, _, _ = jax.jit(jm.forward)(jp, jnp.asarray(tokens))
    got = tm.forward(tp, torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 2e-2


def test_teacher_forced_decode_matches_jax():
    jm, jp, tm, tp = _models("tinyllama-1.1b")
    b, s, pre = 2, 20, 8
    tokens = _tokens((b, s), tm.cfg.vocab, seed=2)
    jcache = jm.init_cache(b, s)
    jlogits, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(tokens[:, :pre]),
                                          jcache)
    tcache = tm.init_cache(b, s, "cpu")
    tt = torch.from_numpy(tokens)
    assert _rel(tm.prefill(tp, tt[:, :pre], tcache), jlogits) <= 2e-2
    step = jax.jit(jm.decode_step)
    for i in range(pre, s):
        jlogits, jcache = step(jp, jnp.asarray(tokens[:, i:i + 1]), jcache,
                               jnp.asarray(i, jnp.int32))
        got = tm.decode_step(tp, tt[:, i:i + 1], tcache, i)
        assert _rel(got, jlogits) <= 3e-2, i


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma-hd256"])
def test_prefill_at_flash_threshold_matches_jax(arch):
    """Prompt of FLASH_THRESHOLD tokens: both frameworks take their flash
    branch (the JAX chunked reference, the port's plain twin), at head dim
    64 (TinyLlama) and 256 (Gemma-shaped)."""
    jm, jp, tm, tp = _models(arch)
    s = ops.FLASH_THRESHOLD
    tokens = _tokens((1, s), tm.cfg.vocab, seed=3)
    want, _ = jax.jit(jm.prefill)(jp, jnp.asarray(tokens),
                                  jm.init_cache(1, s))
    cache = tm.init_cache(1, s, "cpu")
    got = tm.prefill(tp, torch.from_numpy(tokens), cache)
    assert _rel(got, want) <= 2e-2
    assert fa.flash_attention.launches == 0
    assert cache["seg0"][-1]["kv"]["k"][:, s - 1].abs().sum() > 0


def test_serve_main_on_cpu():
    toks = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4"])
    assert toks.shape == (2, 4) and toks.device.type == "cpu"
    assert int(toks.min()) >= 0 and int(toks.max()) < 256


def test_serve_main_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--reduced", "--gen", "2"])


@pytest.mark.parametrize("arch", jconfigs.all_archs())
def test_every_arch_builds(arch):
    """Every architecture of the JAX package builds in the port, full and
    reduced, as the JAX `build` builds it: `WhisperLM` for the
    encoder-decoder, `LM` for the rest, with the same layer plan."""
    for reduced in (False, True):
        cfg = tconfigs.get(arch, reduced=reduced)
        model = tlm.build(cfg)
        want = jlm.build(jconfigs.get(arch, reduced=reduced))
        assert type(model).__name__ == type(want).__name__
        assert [(g.kind, g.count, g.window) for g in model.plan] == [
            (g.kind, g.count, g.window) for g in want.plan]
