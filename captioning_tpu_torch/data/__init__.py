"""Port of ``captioning_tpu.data`` (see the package docstring): copies of
``dataset.py``, ``hybrid_loader.py`` and ``native_io.py``, and the
raw-image loader ``dataloaderraw.py`` over the port's ResNet
(``models/resnet.py``)."""
