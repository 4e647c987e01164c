from .datasets import (OneLesionSegmentation, TestSegmentation,
                       batch_iterator, prefetch, train_val_split)
from .paths import Lesion, get_datapath, lesion_dict
from .transforms import TRANSFORM_REGISTRY, get_transform

__all__ = ["get_transform", "TRANSFORM_REGISTRY", "lesion_dict",
           "get_datapath", "Lesion", "TestSegmentation", "batch_iterator",
           "OneLesionSegmentation", "prefetch", "train_val_split"]
