"""PyTorch/CUDA port of ``distributed_deep_learning_tpu`` for NVIDIA Hopper.

A package of its own beside the JAX package, with the same module names
(``models/transformer.py``, ``ops/paged_decode.py``, ``serve/engine.py``,
...).  It imports ``torch`` and numpy and nothing of JAX or of the JAX
package.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; asking for ``cuda`` without a card raises.
"""

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; ``cuda`` without a visible
    card raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA card "
                           "is visible (pass device='cpu' to run on the "
                           "CPU)")
    return dev
