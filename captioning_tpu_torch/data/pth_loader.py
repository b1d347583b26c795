"""Map-style CaptionDataset (copy of ``captioning_tpu/data/pth_loader.py``,
itself a port of the reference ``captioning/data/pth_loader.py``).

A plain-index dataset (no resumable sampler) for integrating with external
batching frameworks; the threaded DataLoader in dataset.py is the primary
training path.  Indexing semantics and collate output match the reference
CaptionDataset (same seq_per_img caption sampling, labels/masks/gts).
"""

from __future__ import annotations

from typing import Any, Dict, List

from .dataset import Dataset


class CaptionDataset(Dataset):
    """Integer-indexed view of the split-agnostic Dataset."""

    def __getitem__(self, index: int):
        return self.get_item((index, index + 1, False))

    def collate_batch(self, items: List[Any],
                      split: str = 'train') -> Dict[str, Any]:
        return self.collate(items, split)
