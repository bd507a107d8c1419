"""Training loops of the port (latent DDPM on cached latents so far)."""
