"""``python -m distributed_deep_learning_tpu_torch.serve``: the serving
bench, :mod:`distributed_deep_learning_tpu_torch.scripts.serve_bench`
(its flags, ``--obs`` and the rest, and its one JSON record)."""

import sys

from distributed_deep_learning_tpu_torch.scripts.serve_bench import main

if __name__ == "__main__":
    sys.exit(main())
