"""The comparison that decides `correct`: numbers worked out from the
program's outputs and the reference's, each held to its limit in
`limits/<workload>.json`.

Training (the first `checked_steps` steps, which set-up drives through the
window's own step call and feed):
- loss_gap: the largest |loss - reference loss| / |reference loss| over
  the checked steps;
- grad_gap: over the leaves, the largest gap between the norm of the
  program's first gradient as AdamW took it (|m| / (1 - b1) after step 1,
  clipping included) and the reference's, over the larger of that leaf's
  reference norm and the median leaf's;
- update_gap: the same for the norm of each leaf's change over the checked
  steps, leaving out leaves whose reference gradient is under 1e-3 of the
  median leaf's (Adam moves those by round-off alone).
Serving (the checked requests' last positions, where the one served token
is chosen):
- logit_gap: over the checked requests, the largest relative L2 distance
  |program's logits - reference's| / |reference's| of the prefill's
  last-position logits, as the timed `generate` calls produced them;
- logit_gap_median: the median of those distances over the requests;
- token_gap: the widest gap by which a served token's logit lies below the
  reference's best logit at that position, over the checked requests;
- token_gap_mean: the mean of those gaps over the checked requests.
A request whose answer never came counts as failed and makes the run not
correct."""

from __future__ import annotations

import statistics

import torch

NOUGHT = 1e-3   # a leaf's reference gradient under this x the median's


def _worst(prog, ref, names, keep=None):
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median(ref[i] for i in idx)
    worst, leaf = -1.0, ""
    for i in idx:
        gap = abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30)
        if gap > worst:
            worst, leaf = gap, names[i]
    return worst, leaf


def train_numbers(prog: dict, ref: dict, names: list[str]) -> dict:
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    grad_gap, grad_leaf = _worst(prog["grad_norms"], ref["grad_norms"], names)
    med = statistics.median(ref["grad_norms"])
    moved = [g >= NOUGHT * med for g in ref["grad_norms"]]
    upd_gap, upd_leaf = _worst(prog["delta_norms"], ref["delta_norms"],
                               names, moved)
    return {"numbers": {"loss_gap": loss_gap, "grad_gap": grad_gap,
                        "update_gap": upd_gap},
            "where": {"grad_gap": grad_leaf, "update_gap": upd_leaf,
                      "leaves_left_out": moved.count(False)}}


def token_gaps(ref_logits, served) -> list[float]:
    """Per request: reference best logit - reference logit of the served
    token.  ref_logits (N, V) float32, served (N,) ints."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, served.long()[:, None])[:, 0]
    return (best - got).tolist()


def logit_gaps(ref_logits, logits) -> list[float]:
    """Per request: |logits - ref_logits| / |ref_logits| (L2 over the
    vocabulary).  Both (N, V); the program's are taken as float32."""
    ref = ref_logits.float()
    diff = logits.to(ref.device, torch.float32) - ref
    return (diff.norm(dim=-1) / ref.norm(dim=-1)).tolist()


def serve_numbers(gaps: list[float], rel: list[float]) -> dict:
    """`gaps`: token gaps, `rel`: logit gaps, one a checked request each."""
    return {"numbers": {"logit_gap": max(rel),
                        "logit_gap_median": statistics.median(rel),
                        "token_gap": max(gaps),
                        "token_gap_mean": sum(gaps) / len(gaps)},
            "where": {"requests_checked": len(gaps),
                      "requests_off_best": sum(g > 0 for g in gaps)}}


def judge(numbers: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that the
    cell's limits name; a number without a limit is not compared."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"limits name numbers that the run has not: {missing}")
    check = {}
    ok = failed == 0
    for name, limit in limits.items():
        check[name] = {"value": numbers[name], "limit": limit}
        ok = ok and numbers[name] <= limit
    return ok, check
