"""Port of ``captioning_tpu.utils`` (see the package docstring)."""
