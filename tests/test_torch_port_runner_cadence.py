"""The runner's cadences (continued from tests/test_torch_port_runner.py,
which runs the reference beside the port): `checkpoint_every` thins the
diffusion saves to the steps tests/test_checkpoint_cadence.py holds the
reference to, and the VAE-GAN's; the epoch-by-epoch form
(`fused_epochs=False`) and a thinned VAE-GAN stage keep the best-epoch
rule."""
import os

import pytest

from flowerdiff_torch.train.checkpoints import CheckpointManager
from torch_port_runner_common import QUIET, STEPS, _best_rule, _port, _steps
from torch_port_threads import one_thread_per_process  # noqa: F401 (autouse)


def test_checkpoint_every_thins_the_saves_as_the_reference(tmp_path):
    """tests/test_checkpoint_cadence.py's settings (viz cadence 2, 6
    epochs): the reference leaves [2, 4, 6] by default, [3, 6] with
    checkpoint_every=3; the VAE-GAN stage saves at its own cadence of 3."""
    port = _port(tmp_path, diffusion_visualize_every=2, vae_visualize_every=2)
    port.run_latent(total_epochs=6, vae_epochs=4, checkpoint_every=3, **QUIET)
    assert _steps(port.results_dir, "ckpt_diffusion") == [3, 6]
    assert _steps(port.results_dir, "ckpt_vae") == _best_rule(port.results_dir, 4, 3)


@pytest.mark.parametrize("fused,every", [(False, None), (True, 100), (False, 4)])
def test_vae_gan_best_state_saves_keep_the_rule(tmp_path, fused, every):
    """6 VAE-GAN epochs at a viz cadence of 2: the best epoch so far at each
    save point and the final state, in the fused and the epoch-by-epoch
    forms; the saved best holds that epoch's state (its step count)."""
    port = _port(tmp_path, fused=fused, vae_visualize_every=2)
    port.run_latent(total_epochs=1, vae_epochs=6, checkpoint_every=every, **QUIET)
    steps = _steps(port.results_dir, "ckpt_vae")
    assert steps == _best_rule(port.results_dir, 6, every or 2)
    assert 6 in steps and (every != 100 or len(steps) <= 2)
    mgr = CheckpointManager(os.path.join(port.results_dir, "ckpt_vae"))
    for s in steps:
        assert int(mgr.restore(s)["gen"]["step"]) == min(s + 1, 6) * STEPS


def test_cadence_figures_have_the_reference_s_names(tmp_path, monkeypatch):
    """One epoch of each stage at cadence 1: the VAE-GAN's reconstruction
    and t-SNE figures, and for the first two classes the diffusion stage's
    GIF, sample strip and denoising path, named as the reference names
    them (the 300-dpi denoising-path figure recorded, not drawn: it is held
    against the reference in tests/test_torch_port_viz_figures.py)."""
    from flowerdiff_torch import viz

    def denoising_path(*args, save_path=None, **kw):
        assert args[5] in (0, 1) and not kw
        open(save_path, "wb").close()

    monkeypatch.setattr(viz, "visualize_denoising_steps", denoising_path)
    port = _port(tmp_path)
    port.run_latent(total_epochs=1, vae_epochs=1, batch_size=8, final_sweep=False)
    figures = {"test_vae_reconstruction_epoch_1.png", "vae_latent_space_epoch_1.png"}
    for c in (0, 1):
        figures |= {f"diffusion_animation_class_{c}_epoch_1.gif",
                    f"sample_class_{c}_epoch_1.png", f"denoising_path_{c}_epoch_1.png"}
    assert figures <= set(os.listdir(port.results_dir))
    assert not [n for n in os.listdir(port.results_dir)
                if n.endswith((".png", ".gif")) and n not in figures
                and n not in ("autoencoder_losses.png", "diffusion_loss.png")]
