"""Training loops of the port: latent DDPM, VAE-GAN and pixel DDPM, their
fused epochs, the optimizers and schedules, checkpoints and loss history."""
