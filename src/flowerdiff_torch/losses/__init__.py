from flowerdiff_torch.losses.center import (
    center_loss,
    standalone_center_loss,
    update_centers,
)
from flowerdiff_torch.losses.distances import euclidean_distance_loss
from flowerdiff_torch.losses.gan import bce_loss, discriminator_loss, generator_adv_loss
from flowerdiff_torch.losses.kl import kl_divergence

__all__ = ["bce_loss", "center_loss", "discriminator_loss", "euclidean_distance_loss",
           "generator_adv_loss", "kl_divergence", "standalone_center_loss", "update_centers"]
