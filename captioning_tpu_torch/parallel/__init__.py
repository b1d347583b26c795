"""Port of ``captioning_tpu.parallel``: the data axis over processes, one
process a rank (``mesh``), and the launcher that starts the ranks on one
host (``launch``)."""
