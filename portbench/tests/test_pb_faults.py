"""A run of each cell on the CPU at a tiny size, the look for a chip
skipped, with the timed path broken underneath: `correct` comes out false
for each fault the cell can have, and true without one.  (The exchange
between chips has no fault to plant: every cell runs on one chip.)

The limits here are the tiny size's (its sound runs read about a tenth of
them); each fault also reads above the real cell's limit."""

import json

import pytest
import torch

from portbench import spec
from portbench.tests import tiny
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models import lm as lm_mod
from repro_torch.optim import optimizer

TINY_LIMITS = {"train": {"loss_gap": 3e-3, "grad_gap": 2e-2,
                         "update_gap": 1.5e-2},
               "serve": {"logit_gap": 0.05, "logit_gap_median": 0.02,
                         "token_gap": 0.05, "token_gap_mean": 0.02}}
TRAIN = "minicpm-2b.train.4x2048"
SERVES = ["deepseek-moe-16b.serve.longprompt"]


@pytest.fixture
def bench(tmp_path):
    root, here = tiny.copy(tmp_path)
    for w in [TRAIN] + SERVES:
        kind = "train" if w == TRAIN else "serve"
        (here / "limits" / f"{w}.json").write_text(
            json.dumps(TINY_LIMITS[kind]))
    return root, here


def _beyond_real_limit(workload, check) -> bool:
    real = spec.limits(workload)
    return any(check[n]["value"] > limit for n, limit in real.items())


def test_training_is_correct_without_a_fault(bench):
    result, _ = tiny.run(*bench, TRAIN)
    assert result["correct"], result["check"]


def test_a_step_that_leaves_its_state_unchanged_is_caught(bench,
                                                          monkeypatch):
    def unchanged(state, grads, cfg, grad_transform=None):
        state.step += 1
        return state
    monkeypatch.setattr(optimizer, "adamw_update", unchanged)
    result, _ = tiny.run(*bench, TRAIN)
    assert not result["correct"]
    assert result["check"]["update_gap"]["value"] == pytest.approx(1.0)
    assert _beyond_real_limit(TRAIN, result["check"])


def test_half_the_batch_left_out_is_caught(bench, monkeypatch):
    loss = lm_mod.LM.loss

    def half(self, params, batch):
        return loss(self, params, {k: v[: v.shape[0] // 2]
                                   for k, v in batch.items()})
    monkeypatch.setattr(lm_mod.LM, "loss", half)
    result, _ = tiny.run(*bench, TRAIN)
    assert not result["correct"]
    assert _beyond_real_limit(TRAIN, result["check"])


@pytest.mark.parametrize("workload", SERVES)
def test_serving_is_correct_without_a_fault(bench, workload):
    result, _ = tiny.run(*bench, workload)
    assert result["correct"], result["check"]
    assert result["failed"] == 0


@pytest.mark.parametrize("workload", SERVES)
def test_an_altered_token_is_caught(bench, workload, monkeypatch):
    generate = serve.generate

    def altered(model, params, prompts, max_seq, gen, frames=None):
        return (generate(model, params, prompts, max_seq, gen) + 1) \
            % model.cfg.vocab
    monkeypatch.setattr(serve, "generate", altered)
    result, _ = tiny.run(*bench, workload)
    assert not result["correct"]
    assert _beyond_real_limit(workload, result["check"])


@pytest.mark.parametrize("workload", SERVES)
def test_logits_wrong_under_the_same_token_are_caught(bench, workload,
                                                      monkeypatch):
    unembed = layers.unembed

    def stretched(*args, **kwargs):   # argmax kept, every logit x 1.5
        return unembed(*args, **kwargs) * 1.5
    monkeypatch.setattr(layers, "unembed", stretched)
    result, _ = tiny.run(*bench, workload)
    assert not result["correct"]
    assert result["check"]["token_gap"]["value"] < 1e-3
    assert result["check"]["logit_gap_median"]["value"] > 0.4
    assert _beyond_real_limit(workload, result["check"])


@pytest.mark.parametrize("workload", SERVES)
def test_half_the_batch_left_out_of_serving_is_caught(bench, workload,
                                                      monkeypatch):
    generate = serve.generate

    def half(model, params, prompts, max_seq, gen, frames=None):
        return generate(model, params, prompts[: prompts.shape[0] // 2],
                        max_seq, gen)
    monkeypatch.setattr(serve, "generate", half)
    result, _ = tiny.run(*bench, workload)
    assert not result["correct"]
    assert result["failed"] == result["attempted"] // 2
    assert torch.cuda.device_count() == 0
