"""Port of ``captioning_tpu.data`` (see the package docstring): copies of
``dataset.py``, ``hybrid_loader.py`` and ``native_io.py``.  The raw-image
loader (``dataloaderraw.py``) needs the JAX ResNet and is not ported."""
