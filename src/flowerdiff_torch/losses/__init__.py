from flowerdiff_torch.losses.distances import euclidean_distance_loss

__all__ = ["euclidean_distance_loss"]
