"""``runtime.selftest`` on two spawned gloo ranks, under ``--zero fsdp``
and under ``--mesh model=2``: every rank prints its ``SELFTEST`` line,
and the lines agree but for the rank (the same last loss and the same
checksum of the whole parameters)."""

import re

import pytest

from distributed_deep_learning_tpu_torch.runtime.launch import launch_local
from _torch_cpu import torch_threads  # noqa: F401  (autouse)

LINE = re.compile(r"^SELFTEST rank=(\d) world=2 (loss=\S+ checksum=\S+)$",
                  re.M)


@pytest.mark.parametrize("flags", [["--zero", "fsdp"],
                                   ["--mesh", "model=2"]])
def test_selftest_lines_agree_on_every_rank(flags):
    results = launch_local(
        2, [*flags, "-d", "cpu"], device="cpu", timeout=120.0,
        module="distributed_deep_learning_tpu_torch.runtime.selftest")
    lines = [LINE.findall(res.stdout) for res in results]
    assert [[r for r, _ in found] for found in lines] == [["0"], ["1"]]
    assert lines[0][0][1] == lines[1][0][1]
    loss = float(lines[0][0][1].split()[0].split("=")[1])
    assert 0 < loss < 100
