"""Entry points of the port that are not the CLIs under ``tools/``: the
kernel benches, run as ``python -m captioning_tpu_torch.tools.<name>``."""
