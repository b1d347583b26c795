"""Port of ``captioning_tpu.modules`` (see the package docstring)."""
