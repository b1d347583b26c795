"""Port of ``captioning_tpu.utils`` (see the package docstring).  ``opts``,
``config``, ``misc``, ``coco_eval`` and the scorers it imports are copies
of the JAX package's host-only modules (``misc`` only the part the port
uses), so that the port imports nothing of ``captioning_tpu``."""
