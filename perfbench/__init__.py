"""The benchmark of the PyTorch / H100 port (``captioning_tpu_torch``):
see ``run.py`` and ``harness.py``."""
