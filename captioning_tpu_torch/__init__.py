"""PyTorch / CUDA port of the captioning framework, for NVIDIA Hopper.

The JAX package ``captioning_tpu`` is the reference this package is held
against: the same configs, checkpoints (``model.npz`` + infos pickles) and
decode semantics, with every Pallas kernel of the ported paths replaced by
a CUDA kernel written for ``sm_90a`` (``csrc/``, built at first use by
``ops/_build.py``).  The layout mirrors the JAX package: ``models/``,
``engine/``, ``ops/``, ``modules/``, ``utils/``.

This package imports ``torch`` and never ``jax``.  Host-only modules of the
JAX package that pull in no ``jax`` (opts, coco_eval, the data loader) are
imported from there by the eval entry point rather than copied.
"""

__version__ = '0.1.0'
