"""Visualisation suite (port of flowerdiff/viz): the same figures under the
same file names. Importing it needs none of matplotlib, PIL or sklearn:
each function imports what it draws with when it is called (pyplot on the
headless Agg backend)."""
from flowerdiff_torch.viz.animation import create_diffusion_animation
from flowerdiff_torch.viz.color_viz import (
    create_flower_color_visualization,
    generate_class_color_samples,
)
from flowerdiff_torch.viz.curves import plot_loss_curves, plot_single_loss_curve
from flowerdiff_torch.viz.denoise_path import visualize_denoising_steps
from flowerdiff_torch.viz.grids import generate_class_samples, generate_samples_grid
from flowerdiff_torch.viz.latent_compare import visualize_latent_comparison
from flowerdiff_torch.viz.latent_plots import encode_split, visualize_latent_space
from flowerdiff_torch.viz.recon import visualize_reconstructions

__all__ = [
    "generate_samples_grid",
    "generate_class_samples",
    "visualize_reconstructions",
    "visualize_latent_space",
    "encode_split",
    "visualize_denoising_steps",
    "create_diffusion_animation",
    "plot_loss_curves",
    "plot_single_loss_curve",
    "visualize_latent_comparison",
    "create_flower_color_visualization",
    "generate_class_color_samples",
]
