"""Port of ``captioning_tpu.ops`` (see the package docstring)."""
