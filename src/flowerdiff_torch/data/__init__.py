from flowerdiff_torch.data.pipeline import DeviceDataset
from flowerdiff_torch.data.synthetic import synthetic_flowers

__all__ = ["DeviceDataset", "synthetic_flowers"]
