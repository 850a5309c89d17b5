"""Counterparts of the JAX package's ``examples/``: each runs as
``python -m distributed_deep_learning_tpu_torch.examples.<name>`` on the
card, or on the CPU with ``--cpu``, shows what the JAX example shows and
asserts its condition; each exposes ``main(argv=None) -> int``."""
