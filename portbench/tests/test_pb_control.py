"""The control at a size a test run holds: the reference put in the
program's place with its linear layers in float8 comes out not correct
against the float32 reference under each cell's limits (serving at
tiny.MID, where 10 layers amplify rounding as the real models do), while a
run of the harness, the program's timed path, comes out correct under the
same limits; and the reference against itself reads nought."""

import pytest

from portbench import control, correct, spec
from portbench.kinds import train
from portbench.tests import tiny

CELLS = ["minicpm-2b.train.4x2048", "deepseek-moe-16b.serve.longprompt"]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.copy(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def mid(tmp_path_factory):
    return tiny.copy(tmp_path_factory.mktemp("mid"), mid=True)


@pytest.mark.parametrize("seed", [2**31 + 101, 5, 7])
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(bench, mid, workload, seed):
    if "train" in workload:
        run = tiny.make(*bench, workload, seed=seed)
        out = control.train_readings(run)
    else:
        run = tiny.make(*mid, workload, seed=seed, seconds=1.0)
        out = control.serve_readings(run)
        result, _ = tiny.run(*mid, workload, seed=seed, seconds=1.0)
        assert result["correct"], result["check"]
    ok, check = correct.judge(out["control"]["numbers"],
                              spec.limits(workload), failed=0)
    assert not ok, check


def test_the_reference_against_itself_reads_nought(bench):
    run = tiny.make(*bench, "minicpm-2b.train.4x2048")
    feed = train._feed(run)
    a = train.reference_steps(run, feed, 2)
    b = train.reference_steps(run, feed, 2)
    names = [f"leaf{i}" for i in range(len(a["grad_norms"]))]
    nums = correct.train_numbers(a, b, names)["numbers"]
    assert nums == {"loss_gap": 0.0, "grad_gap": 0.0, "update_gap": 0.0}
