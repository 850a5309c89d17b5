"""Staged execution: the port of ``distributed_deep_learning_tpu/parallel``
for the ``model`` and ``pipeline`` modes (partitioners, MPMD staging, the
pipelined transformer trunk and its GPipe, 1F1B and interleaved
schedules)."""
