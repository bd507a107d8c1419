from flowerdiff_torch.data.flowers102 import FLOWERS102_SPLITS, load_flowers102
from flowerdiff_torch.data.pipeline import DeviceDataset, make_augment_fn
from flowerdiff_torch.data.synthetic import synthetic_flowers

__all__ = ["load_flowers102", "FLOWERS102_SPLITS", "synthetic_flowers", "DeviceDataset",
           "make_augment_fn"]
