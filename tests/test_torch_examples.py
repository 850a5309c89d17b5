"""The port's single-process examples (01, 04, 06, 08) run green with
``--cpu`` and print their pass lines; each asserts the JAX example's
condition itself (an accuracy above 30%, a falling loss, a fired chaos
hook and a finished test phase, a positive FLOP count and a trace file).
The multi-rank examples: ``test_torch_examples_ranks.py``."""

import pytest

from _examples_run import run_all
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

PASS_LINES = {
    "01_train_mlp_library_api": "library API on cpu: final train accuracy",
    "04_pipelined_gpt_cli": "pipelined train loss on cpu:",
    "06_elastic_mid_epoch_resume":
        "survived the injected step-5 failure on cpu",
    "08_profiling_toolkit": "hlo_text: skipped",
}


@pytest.fixture(scope="module")
def runs():
    return run_all(PASS_LINES)


@pytest.mark.parametrize("name", sorted(PASS_LINES))
def test_example_runs_green_on_the_cpu(runs, name):
    rc, out, _ = runs[name]
    assert rc == 0, out[-3000:]
    assert PASS_LINES[name] in out, out[-3000:]


def test_profiling_example_skips_the_compiler_text_by_design(runs):
    _, out, _ = runs["08_profiling_toolkit"]
    assert "compiled_text: skipped" in out and "trace: wrote 1 file" in out
    assert "cost_analysis:" in out and "StepTimer:" in out
