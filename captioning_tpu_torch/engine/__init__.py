"""Port of ``captioning_tpu.engine`` (see the package docstring)."""
