from flowerdiff_torch.models.discriminator import Discriminator64
from flowerdiff_torch.models.latent_unet import ConditionalLatentDenoiser
from flowerdiff_torch.models.vae import Decoder, Encoder, FlowerVAE, LatentClassifier
from flowerdiff_torch.models.vgg import VGGFeatures, VGGPerceptual

__all__ = ["ConditionalLatentDenoiser", "Decoder", "Discriminator64", "Encoder", "FlowerVAE",
           "LatentClassifier", "VGGFeatures", "VGGPerceptual"]
