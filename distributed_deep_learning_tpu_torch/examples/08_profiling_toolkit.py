"""The profiling toolkit: see what a train step costs.

``utils.profiling`` runs each diagnostic on a small train step:

* ``cost_analysis``: the step's FLOPs from PyTorch's FLOP counter (the
  products, convolutions and attention calls), the input to a roofline;
* ``memory_analysis``: the caching allocator's bytes around one step on
  the card (live at entry, left live, the peak above that);
* ``StepTimer``: steps/sec with the first (warm-up) step excluded;
* ``trace``: a ``torch.profiler`` Chrome trace directory (open it in
  Perfetto or chrome://tracing).

The JAX example also prints the program before and after XLA's
optimisation (``hlo_text``, ``compiled_text``).  Eager PyTorch has no
compiler text, so the port's raise by design and this example says it
skips them.

    python -m distributed_deep_learning_tpu_torch.examples.08_profiling_toolkit
    python -m distributed_deep_learning_tpu_torch.examples.08_profiling_toolkit --cpu
"""

import os
import sys
import tempfile

from distributed_deep_learning_tpu_torch.examples import _bootstrap


def main(argv=None) -> int:
    args = _bootstrap.parser(__doc__).parse_args(argv)
    device = _bootstrap.device(args)

    import numpy as np
    import torch

    from distributed_deep_learning_tpu_torch.models.mlp import MLP
    from distributed_deep_learning_tpu_torch.train.objectives import RowMean
    from distributed_deep_learning_tpu_torch.train.state import (
        Optimizer, create_train_state)
    from distributed_deep_learning_tpu_torch.train.step import make_step_fns
    from distributed_deep_learning_tpu_torch.utils import profiling

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(64, 48)).astype(np.float32)) \
        .to(device)
    y = torch.from_numpy(np.eye(5, dtype=np.float32)[
        rng.integers(0, 5, 64)]).to(device)
    model = MLP(48, hidden_size=256, num_hidden_layers=2, num_classes=5)
    state = create_train_state(model, 0, Optimizer("momentum", 0.05),
                               device=device)
    train_step, _ = make_step_fns(RowMean())

    # 1. the FLOP counter's cost of this exact step
    cost = profiling.cost_analysis(train_step, state, x, y)
    flops = cost.get("flops", 0)
    print(f"cost_analysis: {flops:.3g} FLOPs (products only; the counter "
          "reports no bytes accessed)")

    # 2. XLA's program text has no counterpart in eager PyTorch
    for name in ("hlo_text", "compiled_text"):
        try:
            getattr(profiling, name)(train_step, state, x, y)
        except NotImplementedError as e:
            print(f"{name}: skipped ({e})")

    # 3. the allocator's view of one step (the card only)
    mem = profiling.memory_analysis(train_step, state, x, y, device=device)
    if mem:
        print(f"memory_analysis: {mem['argument_size_in_bytes']} B live at "
              f"entry, {mem['output_size_in_bytes']} B left, "
              f"{mem['temp_size_in_bytes']} B peak above that")
    else:
        print("memory_analysis: {} on the CPU (no allocator to read)")

    # 4. throughput meter (skips the first step)
    timer = profiling.StepTimer(warmup=1)
    for _ in range(6):
        state, m = train_step(state, x, y)
        float(m["loss"])                 # host fetch = device barrier
        timer.tick(examples=len(x))
    rates = timer.summary()
    print(f"StepTimer: {rates['steps_per_sec']:.1f} steps/s, "
          f"{rates['examples_per_sec']:.0f} examples/s")

    # 5. the profiler's trace
    with tempfile.TemporaryDirectory() as trace_dir:
        with profiling.trace(trace_dir):
            with profiling.annotate("profiled-step"):
                state, m = train_step(state, x, y)
                float(m["loss"])
        n_files = sum(len(fs) for _, _, fs in os.walk(trace_dir))
        print(f"trace: wrote {n_files} file(s) under {trace_dir} on "
              f"{device} (open in Perfetto / chrome://tracing)")
    assert flops > 0 and n_files > 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
