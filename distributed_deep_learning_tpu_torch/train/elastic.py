"""Resume points: ``resume_point`` of
``distributed_deep_learning_tpu/train/elastic.py`` (lines 38-59).  The
rest of that module, the restart loop, is ``ROADMAP.md`` queue 1 item 12.
"""

from __future__ import annotations

from distributed_deep_learning_tpu_torch.utils.checkpoint import \
    Checkpointer


def resume_point(checkpointer: Checkpointer, step: int | None = None
                 ) -> tuple[int | None, int, int, dict | None]:
    """Decode a checkpoint (default: latest) into ``(ckpt_step,
    start_epoch, resume_batch, resume_totals)``: ``ckpt_step`` None means
    start fresh; ``resume_batch > 0`` means mid-epoch (skip that many
    batches of ``start_epoch`` and seed its totals).  A checkpoint without
    a sidecar counts its id as the completed epoch.  Pass ``step`` when
    the integrity fallback restored an older step than the latest."""
    last = checkpointer.latest_step() if step is None else step
    if last is None:
        return None, 1, 0, None
    extra = checkpointer.read_extra(last)
    if extra is None:
        return last, last + 1, 0, None
    if extra.get("epoch_complete"):
        return last, int(extra["epoch"]) + 1, 0, None
    return last, int(extra["epoch"]), int(extra["batch"]), \
        extra.get("totals")
