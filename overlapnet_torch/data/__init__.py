"""Data layer: ground-truth pair files, balancing, sequence packs, the
native batcher and the input pipeline."""

from overlapnet_torch.data.balancing import normalize_overlap_distribution, split_train_val
from overlapnet_torch.data.gt_files import PairList, load_gt_pairs, save_gt_files
from overlapnet_torch.data.dataset import PairImageDataset

__all__ = [
    "PairList",
    "load_gt_pairs",
    "save_gt_files",
    "normalize_overlap_distribution",
    "split_train_val",
    "PairImageDataset",
]
