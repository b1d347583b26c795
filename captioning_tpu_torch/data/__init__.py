"""Port of ``captioning_tpu.data`` (see the package docstring): copies of
``dataset.py``, ``hybrid_loader.py``, ``native_io.py`` and
``pth_loader.py`` (``CaptionDataset``, the map-style view), and the
raw-image loader ``dataloaderraw.py`` over the port's ResNet
(``models/resnet.py``)."""

from .pth_loader import CaptionDataset

__all__ = ['CaptionDataset']
