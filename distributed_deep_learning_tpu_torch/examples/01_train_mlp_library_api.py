"""Minimal library-API training run (no CLI): the five-call recipe.

    device -> loaders -> model -> step fns -> fit

This is what ``python -m distributed_deep_learning_tpu_torch mlp`` does
under the hood (``workloads/base.py`` wires the same pieces plus
checkpoints, elastic restart and the parallel modes).

    python -m distributed_deep_learning_tpu_torch.examples.01_train_mlp_library_api
    python -m distributed_deep_learning_tpu_torch.examples.01_train_mlp_library_api --cpu

It trains on the card unless ``--cpu``; the JAX example's 8-device data
mesh becomes one device (the multi-rank examples are 02, 03, 05 and 07).
"""

import sys

from distributed_deep_learning_tpu_torch.examples import _bootstrap


def main(argv=None) -> int:
    args = _bootstrap.parser(__doc__).parse_args(argv)
    device = _bootstrap.device(args)

    from distributed_deep_learning_tpu_torch.data.datasets import \
        synthetic_mqtt
    from distributed_deep_learning_tpu_torch.data.loader import make_loaders
    from distributed_deep_learning_tpu_torch.data.splits import \
        train_val_test_split
    from distributed_deep_learning_tpu_torch.models.mlp import MLP
    from distributed_deep_learning_tpu_torch.train.loop import fit
    from distributed_deep_learning_tpu_torch.train.objectives import RowMean
    from distributed_deep_learning_tpu_torch.train.state import (
        Optimizer, create_train_state)
    from distributed_deep_learning_tpu_torch.train.step import make_step_fns
    from distributed_deep_learning_tpu_torch.utils.logging import PhaseLogger

    # 1. dataset + seeded 70/10/20 split + loaders that hand each batch to
    #    the device
    ds = synthetic_mqtt(n=4096)                 # MQTT-IDS shape twin
    splits = train_val_test_split(len(ds), seed=42)
    loaders = make_loaders(ds, splits, 64, device, seed=42)

    # 2. model + optimizer -> TrainState, on the device
    model = MLP(ds.features.shape[1], num_classes=5)
    state = create_train_state(model, 42, Optimizer("momentum", 0.05),
                               device=device)

    # 3. the train/eval steps: forward, loss, backward, update
    train_step, eval_step = make_step_fns(RowMean())

    # 4. the reference-grammar training loop
    state, history = fit(state, train_step, eval_step, *loaders, epochs=3,
                         logger=PhaseLogger(verbose=True))
    final_train = [r for r in history if r.phase == "train"][-1]
    print(f"library API on {device}: final train accuracy "
          f"{final_train.accuracy:.1f}%")
    assert final_train.accuracy > 30.0, "did not learn"
    return 0


if __name__ == "__main__":
    sys.exit(main())
