"""PyTorch / CUDA port of the captioning framework, for NVIDIA Hopper.

The JAX package ``captioning_tpu`` is the reference this package is held
against: the same configs, checkpoints (``model.npz`` + infos pickles) and
decode semantics, with every Pallas kernel of the ported paths replaced by
a CUDA kernel written for ``sm_90a`` (``csrc/``, built at first use by
``ops/_build.py``).  The layout mirrors the JAX package: ``models/``,
``engine/``, ``ops/``, ``modules/``, ``utils/``.

This package imports ``torch`` and never ``jax``, nor anything of
``captioning_tpu``: the host-only modules it needs from there (opts,
config, misc, coco_eval and its scorers, the data loader) are copied into
``utils/`` and ``data/``.  Its entry points run on the GPU unless the CPU
is asked for.
"""

__version__ = '0.1.0'
