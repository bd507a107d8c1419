from flowerdiff_torch.data.pipeline import DeviceDataset, make_augment_fn
from flowerdiff_torch.data.synthetic import synthetic_flowers

__all__ = ["DeviceDataset", "make_augment_fn", "synthetic_flowers"]
