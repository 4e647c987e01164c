from .datasets import TestSegmentation, batch_iterator
from .paths import Lesion, get_datapath, lesion_dict
from .transforms import TRANSFORM_REGISTRY, get_transform

__all__ = ["get_transform", "TRANSFORM_REGISTRY", "lesion_dict",
           "get_datapath", "Lesion", "TestSegmentation", "batch_iterator"]
