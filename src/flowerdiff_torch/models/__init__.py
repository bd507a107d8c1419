from flowerdiff_torch.models.latent_unet import ConditionalLatentDenoiser
from flowerdiff_torch.models.vae import Decoder, FlowerVAE

__all__ = ["ConditionalLatentDenoiser", "Decoder", "FlowerVAE"]
