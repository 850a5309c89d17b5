"""FSDP (ZeRO-3): the same step, a sharded model.

The parameters, gradients and optimizer state are split across the ranks
(``parallel.zero.apply_fsdp``, PyTorch's FSDP2 over a ``fsdp`` mesh
axis); each step all-gathers the parameters for the forward and
reduce-scatters the gradients into the shards.  The train step is the
data-parallel one, over each rank's rows of the batch.

    python -m distributed_deep_learning_tpu_torch.examples.03_fsdp_sharded_training
    python -m distributed_deep_learning_tpu_torch.examples.03_fsdp_sharded_training --cpu --ranks 2

The JAX example's model, data and steps: a wide MLP (1024 x 4 layers),
64 rows of 48 features, AdamW 1e-3, 10 steps; the pass condition is a
falling loss.  ``--zero 1`` on the CLI shards only the optimizer state;
both are what the CLI's ``--zero {1,fsdp}`` wires.
"""

import sys

from distributed_deep_learning_tpu_torch.examples import _bootstrap

MODULE = "distributed_deep_learning_tpu_torch.examples." \
    "03_fsdp_sharded_training"


def main(argv=None) -> int:
    args = _bootstrap.parser(__doc__, ranks=True).parse_args(argv)
    if not _bootstrap.in_rank():
        return _bootstrap.launch(MODULE, args, argv)

    import numpy as np
    import torch

    from distributed_deep_learning_tpu_torch.data.loader import local_rows
    from distributed_deep_learning_tpu_torch.models.mlp import MLP
    from distributed_deep_learning_tpu_torch.parallel.zero import apply_fsdp
    from distributed_deep_learning_tpu_torch.runtime import bootstrap
    from distributed_deep_learning_tpu_torch.runtime.mesh import (MeshLayout,
                                                                  build_mesh)
    from distributed_deep_learning_tpu_torch.train.objectives import RowMean
    from distributed_deep_learning_tpu_torch.train.state import (
        Optimizer, create_train_state)
    from distributed_deep_learning_tpu_torch.train.step import make_step_fns

    env, created = _bootstrap.process_group(args)
    try:
        dev = env.device
        layout = MeshLayout.of(build_mesh({"fsdp": env.world}, dev.type))
        # a deliberately wide MLP so parameter shards are non-trivial
        model = MLP(48, hidden_size=1024, num_hidden_layers=4, num_classes=5)
        rng = np.random.default_rng(0)
        x = rng.normal(size=(64, 48)).astype(np.float32)
        y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 64)]
        own = local_rows(64, layout.batch_rank, layout.batch_world)
        xl, yl = (torch.from_numpy(t[own]).to(dev) for t in (x, y))

        state = create_train_state(
            model, 0, Optimizer("adamw", 1e-3), device=dev,
            shard=lambda m: apply_fsdp(m, layout))  # <- the whole difference
        train_step, _ = make_step_fns(RowMean(), global_batch=True,
                                      group=layout.batch_group)
        losses = []
        for _ in range(10):
            state, metrics = train_step(state, xl, yl)
            losses.append(float(metrics["loss"]))

        name, big = max(state.model.named_parameters(),
                        key=lambda kv: kv[1].numel())
        if env.rank == 0:
            print(f"largest param {name} {tuple(big.shape)} placements "
                  f"{big.placements}, this rank holds "
                  f"{tuple(big.to_local().shape)} on {dev}")
            print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f}")
        assert losses[-1] < losses[0], "did not learn"
    finally:
        if created:
            bootstrap.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
