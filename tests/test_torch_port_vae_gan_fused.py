"""flowerdiff_torch's fused VAE-GAN epochs on the CPU against the JAX
package's, the plain form, the reference's augmentation and noise draws
injected (the case's body: torch_port_vae_gan_common.fused_epochs_case;
the best-state form: test_torch_port_vae_gan_best.py).
"""
import pytest

from torch_port_vae_gan_common import (  # noqa: F401 (fixtures)
    fused_epochs_case,
    jax_init,
    no_dropout,
    vgg_pair,
)


@pytest.mark.parametrize("track_best", [False])
def test_fused_epochs_match_the_reference(jax_init, vgg_pair, no_dropout, track_best):
    """make_fused_vae_gan_epochs: 2 epochs x 2 steps over 8 augmented
    synthetic images (epoch 170 of 300: every term on, centers updating)
    against the reference's fused epochs, its augmentation draws
    (fold_in(data_key, offset)) and noise (fold_in(fold_in(rng, offset),
    step)) injected. Per-step losses as the trajectory test; each leaf's
    weights and moments after 4 steps, and the centers, as there. With
    track_best: the same best epoch, its loss, and the best state's leaves
    and centers."""
    fused_epochs_case(jax_init, vgg_pair, track_best)
