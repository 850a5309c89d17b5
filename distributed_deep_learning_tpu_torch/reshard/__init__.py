"""Cross-topology elastic resume: restore any checkpoint onto any mesh.
The port of ``distributed_deep_learning_tpu/reshard/``.

Production pods shrink and grow; a checkpoint locked to the topology that
wrote it strands the job until a same-shape spare appears.  This package
turns checkpoints into portable artifacts in three pieces:

* :mod:`.manifest` — a **topology manifest** (mesh axes/shape, per-leaf
  split spec, rank count, format version) written into the integrity
  sidecar of every save of a ``-m data`` run (:mod:`..utils.checkpoint`),
  so a restore can tell *how* the state was laid out, not just that it
  is intact.
* :mod:`.redistribute` — a **portable redistribution layer** taking each
  rank's part of a whole saved leaf: a gather path that always works, and
  a chunked path that copies only the rank's slice from the mapped file
  in pieces, so no card holds a second whole copy (the collective-
  decomposition idiom of arxiv 2112.01075).
* :mod:`.replan` + :mod:`.restore` — the **re-plan-then-reshard restore
  path**: on a restart with a different surviving topology, the
  ``tune/`` planner (analytic memory model, optional quick trials) picks a
  legal plan for the new rank count, the runner builds the state for it,
  and the resharding restore places the verified checkpoint into it.

:mod:`.drill` proves the chain end to end: kill K of N workers, re-plan,
reshard, continue — params equal to a same-topology restore, no human.
"""

from distributed_deep_learning_tpu_torch.reshard.manifest import (  # noqa: F401
    TOPOLOGY_FORMAT, Topology, capture, of_placement, same_topology)
from distributed_deep_learning_tpu_torch.reshard.redistribute import (  # noqa: F401
    RedistributeStats, redistribute, redistribute_leaf, tree_shardings)
from distributed_deep_learning_tpu_torch.reshard.replan import (  # noqa: F401
    choose_plan, latest_topology, replan_config, resolve_restart_topology)
from distributed_deep_learning_tpu_torch.reshard.restore import (  # noqa: F401
    ReshardGeometryError, make_restore_fn, restore_resharded)
