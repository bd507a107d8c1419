from flowerdiff_torch.models.latent_unet import ConditionalLatentDenoiser
from flowerdiff_torch.models.vae import Decoder, Encoder, FlowerVAE

__all__ = ["ConditionalLatentDenoiser", "Decoder", "Encoder", "FlowerVAE"]
