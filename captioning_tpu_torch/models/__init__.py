"""Port of ``captioning_tpu.models`` (see the package docstring)."""
