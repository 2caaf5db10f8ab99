"""The port's training substrate on the CPU: checkpointing, data, gradient
compression, fault handling and the training loop, held to the contracts
of tests/test_substrate.py and tests/test_system.py, and to the JAX
package's own functions on the same arrays where there is one.

The data pipeline and the fault loop are verbatim copies of the JAX
package's numpy / pure-Python modules; the first tests pin the copies.
"""

import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as configs
from repro.distributed import compression as jcomp
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.distributed import compression, fault
from repro_torch.distributed.fault import RestartPolicy, StragglerDetector
from repro_torch.launch import train
from repro_torch.launch.specs import schedule_for
from repro_torch.models import lm as lm_mod
from repro_torch.optim import (AdamWConfig, TrainState, adamw_init,
                               make_train_step)

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("module", ["data/pipeline.py",
                                    "distributed/fault.py"])
def test_copies_are_verbatim(module):
    assert ((SRC / "repro_torch" / module).read_text()
            == (SRC / "repro" / module).read_text())


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _tree(v=0.0):
    return {"a": torch.full((4, 3), v), "b": {"c": torch.arange(5.0) + v,
                                              "d": [torch.ones(2) * v]}}


def test_checkpoint_roundtrip_and_keep_k(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        m.save(s, _tree(s), blocking=True)
    assert m.latest_step() == 30
    assert sorted(m._complete_steps()) == [20, 30]  # gc'd step 10
    step, t = m.restore_latest(_tree())
    assert step == 30
    torch.testing.assert_close(t["a"], torch.full((4, 3), 30.0))
    torch.testing.assert_close(t["b"]["d"][0], torch.full((2,), 30.0))


def test_checkpoint_train_state_keeps_dtypes(tmp_path):
    """A TrainState round trip: the int step, and bf16 leaves (written as
    fp32) restored exactly in the dtype of the structure restored into."""
    params = {"w": torch.randn(3, 4).bfloat16(), "s": torch.randn(4)}
    state = adamw_init(params)
    state.step = 7
    m = CheckpointManager(str(tmp_path))
    m.save(7, state, blocking=True)
    step, got = m.restore_latest(adamw_init({k: torch.zeros_like(v)
                                             for k, v in params.items()}))
    assert step == 7 and isinstance(got, TrainState) and got.step == 7
    assert got.params["w"].dtype == torch.bfloat16
    assert torch.equal(got.params["w"], params["w"])
    assert torch.equal(got.params["s"], params["s"])


def test_checkpoint_snapshot_taken_at_save(tmp_path):
    """An async save holds the values at the call: an in-place update
    right after it (as AdamW does) does not reach the checkpoint."""
    t = _tree(1.0)
    m = CheckpointManager(str(tmp_path))
    m.save(1, t, blocking=False)
    t["a"].add_(100.0)
    m.wait()
    _, got = m.restore_latest(_tree())
    torch.testing.assert_close(got["a"], torch.full((4, 3), 1.0))


def test_checkpoint_async_save(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(5, _tree(5), blocking=False)
    m.wait()
    assert m.latest_step() == 5


def test_checkpoint_corrupt_skipped(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=5)
    m.save(1, _tree(1), blocking=True)
    m.save(2, _tree(2), blocking=True)
    os.remove(os.path.join(str(tmp_path), "step_0000000002",
                           "leaf_00000.npy"))
    step, _ = m.restore_latest(_tree())
    assert step == 1


def test_checkpoint_partial_save_never_visible(tmp_path):
    m = CheckpointManager(str(tmp_path))
    os.makedirs(os.path.join(str(tmp_path), "step_0000000009.tmp"))
    assert m.latest_step() is None


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(1, _tree(), blocking=True)
    bad = _tree()
    bad["a"] = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="shape"):
        m.restore(1, bad)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def test_data_deterministic_and_host_sharded():
    cfg = DataConfig(vocab=97, seq_len=16, global_batch=4)
    d1, d2 = SyntheticTokens(cfg), SyntheticTokens(cfg)
    np.testing.assert_array_equal(d1.batch(7)["tokens"], d2.batch(7)["tokens"])
    assert not np.array_equal(d1.batch(8)["tokens"], d1.batch(7)["tokens"])
    b = d1.batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    h0, h1 = (SyntheticTokens(DataConfig(vocab=97, seq_len=8, global_batch=8,
                                         n_hosts=2, host_index=i)).batch(3)
              for i in (0, 1))
    assert h0["tokens"].shape[0] == h1["tokens"].shape[0] == 4
    assert not np.array_equal(h0["tokens"], h1["tokens"])
    step, batch = next(d1.prefetch(start_step=2))
    assert step == 2
    np.testing.assert_array_equal(batch["tokens"], d1.batch(2)["tokens"])


# ---------------------------------------------------------------------------
# Compression, against the JAX functions on the same arrays
# ---------------------------------------------------------------------------


def test_int8_matches_jax_and_error_is_bounded():
    x = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    q, s = compression.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == pytest.approx(float(js), rel=1e-6)
    err = (compression.dequantize_int8(q, s) - torch.from_numpy(x)).abs()
    assert err.max().item() <= s.item() * 0.5 + 1e-6


def test_topk_matches_jax():
    x = np.asarray([0.1, -5.0, 0.2, 3.0, -0.05], np.float32)
    got = compression.topk_sparsify(torch.from_numpy(x), 0.4)
    np.testing.assert_array_equal(got.numpy(), [0.0, -5.0, 0.0, 3.0, 0.0])
    y = np.random.default_rng(1).standard_normal((8, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        compression.topk_sparsify(torch.from_numpy(y), 0.1).numpy(),
        np.asarray(jcomp.topk_sparsify(jnp.asarray(y), 0.1)))


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_error_feedback_matches_jax_and_preserves_sum(kind):
    rng = np.random.default_rng(2)
    g = {"w": rng.standard_normal(32).astype(np.float32),
         "b": [rng.standard_normal((4, 4)).astype(np.float32)]}
    tg = {"w": torch.from_numpy(g["w"]), "b": [torch.from_numpy(g["b"][0])]}
    comp, jc = compression.EFCompressor(kind=kind), jcomp.EFCompressor(kind=kind)
    out, err = comp(tg, comp.init(tg))
    jg = {"w": jnp.asarray(g["w"]), "b": [jnp.asarray(g["b"][0])]}
    jout, _ = jc(jg, jc.init(jg))
    for t, j, e, x in ((out["w"], jout["w"], err["w"], g["w"]),
                       (out["b"][0], jout["b"][0], err["b"][0], g["b"][0])):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose((t + e).numpy(), x, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Fault handling
# ---------------------------------------------------------------------------


def test_straggler_detection():
    d = StragglerDetector(warmup=5)
    assert not any(d.observe(1.0 + 0.01 * (i % 3)) for i in range(20))
    assert d.observe(10.0)


def test_restart_policy_bounded():
    p = RestartPolicy(max_restarts=2, window_s=100)
    assert p.should_restart(now=0)
    p.record(now=0)
    assert p.should_restart(now=1)
    p.record(now=1)
    assert not p.should_restart(now=2)
    assert p.should_restart(now=200)


# ---------------------------------------------------------------------------
# The training loop (tests/test_system.py's contracts)
# ---------------------------------------------------------------------------


def _setup(tmp_path, seq=32, batch=4):
    cfg = configs.get("tinyllama-1.1b", reduced=True)
    model = lm_mod.build(cfg)
    step = make_train_step(model.loss, AdamWConfig(schedule=schedule_for(cfg)))
    state = adamw_init(model.init(torch.Generator().manual_seed(0),
                                  dtype=torch.float32))
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                      global_batch=batch))
    return state, data, step, CheckpointManager(str(tmp_path), keep=3)


def _stepper(step):
    def fn(st, batch):
        return step(st, {k: torch.from_numpy(v).long()
                         for k, v in batch.items()})
    return fn


def test_fault_recovery_matches_uninterrupted_run(tmp_path):
    """Crash at step 12, restore from step 10, finish: the final loss
    equals the run without the fault (data addressed by step, a
    deterministic step)."""
    n = 18
    s1, data, step, mgr1 = _setup(tmp_path / "a")
    s1, log1 = fault.run_resilient(s1, data, _stepper(step), mgr1,
                                   n_steps=n, checkpoint_every=5)
    s2, data2, step2, mgr2 = _setup(tmp_path / "b")
    s2, log2 = fault.run_resilient(s2, data2, _stepper(step2), mgr2,
                                   n_steps=n, checkpoint_every=5,
                                   fault_at=12)
    assert s1.step == s2.step == n
    assert abs(log1[-1]["loss"] - log2[-1]["loss"]) < 1e-5


def test_resume_across_process_restart(tmp_path):
    state, data, step, mgr = _setup(tmp_path)
    state, _ = fault.run_resilient(state, data, _stepper(step), mgr,
                                   n_steps=10, checkpoint_every=5)
    mgr.save(state.step, state, blocking=True)
    fresh, _, step2, mgr2 = _setup(tmp_path)
    got_step, restored = CheckpointManager(str(tmp_path)).restore_latest(fresh)
    assert got_step == 10
    restored, _ = fault.run_resilient(restored, data, _stepper(step2), mgr2,
                                      n_steps=15, checkpoint_every=100)
    assert restored.step == 15


def test_train_main_loss_falls_on_cpu(tmp_path):
    """`python -m repro_torch.launch.train --reduced --device cpu --steps
    30`: finite losses that fall."""
    losses = train.main(["--arch", "tinyllama-1.1b", "--reduced", "--device",
                         "cpu", "--steps", "30", "--batch", "4", "--seq",
                         "32", "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_train_main_needs_a_gpu_without_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path)])


def test_build_trainer_refuses_non_dense_on_cuda():
    """No family the port builds is refused: RWKV6, the Hymba hybrid,
    DeepSeek-V3 (its MTP loss included) and Whisper (the encoder-decoder)
    train through the wkv6, the selective-scan and the flash kernels (at
    the MLA layout for V3), so on a machine without CUDA each gets as far
    as the device, and there it raises RuntimeError, not
    NotImplementedError."""
    if not torch.cuda.is_available():
        for arch in ("rwkv6-3b", "hymba-1.5b", "deepseek-v3-671b",
                     "whisper-small"):
            with pytest.raises(RuntimeError) as err:
                train.build_trainer(configs.get(arch, reduced=True),
                                    device="cuda")
            assert not isinstance(err.value, NotImplementedError)
