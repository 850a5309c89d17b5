"""Counterparts of the JAX package's ``scripts/``: each runs as
``python -m distributed_deep_learning_tpu_torch.scripts.<name>``, takes
the JAX script's flags (plus ``--device``, ``cuda`` unless given), prints
the JAX script's one JSON record and exposes ``main(argv=None) -> int``.
"""
