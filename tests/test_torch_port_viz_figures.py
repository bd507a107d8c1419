"""flowerdiff_torch.viz's figures against the JAX package's: the
denoising-path figure (its one batched `masked_denoise` call, the start steps
tiled over the samples) and every other figure function, each writing the
reference's file, a PNG of the reference's shape (stubs and helpers in
tests/torch_port_viz_common.py)."""
import os

import numpy as np

from flowerdiff import viz as jviz
from flowerdiff_torch import viz
from torch_port_viz_common import (
    LATENT,
    NAMES,
    Decoders,
    JaxStub,
    TorchStub,
    _encode_mu,
    _images,
    _labels,
    _same_png,
)
from torch_port_threads import one_thread_per_process  # noqa: F401 (autouse)


def test_denoising_path_equals_the_reference(tmp_path):
    js, ts_, dec = JaxStub(), TorchStub(), Decoders()
    x, xj, xt = _images()
    want = jviz.visualize_denoising_steps(
        _encode_mu, dec.jax, js, xj, _labels(), 3, NAMES,
        save_path=str(tmp_path / "j" / "denoising_path_3_final.png"), n_samples=3,
        steps_to_show=4)
    got = viz.visualize_denoising_steps(
        _encode_mu, dec.port, ts_, xt, _labels(), 3, NAMES,
        save_path=str(tmp_path / "p" / "denoising_path_3_final.png"), n_samples=3,
        steps_to_show=4)
    # the start steps (every T // 4-th, descending), each tiled over the 3
    # samples, in one call
    starts = [8, 6, 4, 2, 0]
    (name, shape, cond, t_start), = ts_.calls
    assert (name, shape) == ("masked_denoise", [3 * len(starts), LATENT])
    assert t_start == np.repeat(starts, 3).tolist()
    assert cond == [[3] * 3 * len(starts)]
    assert ts_.calls == js.calls
    np.testing.assert_allclose(dec.port_in[0], dec.jax_in[0], atol=1e-6)
    _same_png(got, want)


def test_every_figure_is_written_as_the_reference_writes_it(tmp_path):
    """Reconstructions, the latent t-SNE, the loss curves, the comparison
    grid and the v3 color figures: the reference's file names, PNGs of its
    shapes."""
    x, xj, xt = _images()
    labels = _labels()
    jd, pd = tmp_path / "jax", tmp_path / "port"
    dec = Decoders()
    pairs = [
        (jviz.visualize_reconstructions(lambda im, rng: im * 0.5, xj, labels, 3, NAMES,
                                        str(jd)),
         viz.visualize_reconstructions(lambda im, gen: im * 0.5, xt, labels, 3, NAMES,
                                       str(pd))),
        (jviz.visualize_latent_space(_encode_mu, xj, labels, 3, NAMES, str(jd)),
         viz.visualize_latent_space(_encode_mu, xt, labels, 3, NAMES, str(pd))),
        (jviz.plot_loss_curves({"total": [3.0, 2.0], "kl": [1.0, 0.5]},
                               str(jd / "autoencoder_losses.png")),
         viz.plot_loss_curves({"total": [3.0, 2.0], "kl": [1.0, 0.5]},
                              str(pd / "autoencoder_losses.png"))),
        (jviz.plot_single_loss_curve([3.0, 2.0, 1.5], str(jd / "diffusion_loss_continued.png"),
                                     start_epoch=4),
         viz.plot_single_loss_curve([3.0, 2.0, 1.5], str(pd / "diffusion_loss_continued.png"),
                                    start_epoch=4)),
        (jviz.visualize_latent_comparison(lambda im, rng: im, dec.jax, JaxStub(), xj, labels,
                                          NAMES, str(jd / "latent_comparison.png")),
         viz.visualize_latent_comparison(lambda im, gen: im, dec.port, TorchStub(), xt, labels,
                                         NAMES, str(pd / "latent_comparison.png"))),
        (jviz.create_flower_color_visualization((x * 255).astype(np.uint8), labels, NAMES,
                                                save_path=str(jd / "color_visualization.png")),
         viz.create_flower_color_visualization((x * 255).astype(np.uint8), labels, NAMES,
                                               save_path=str(pd / "color_visualization.png"))),
    ]
    for want, got in pairs:
        _same_png(got, want)
    js, ts_ = JaxStub(), TorchStub()
    samples_j = jviz.generate_class_color_samples(
        js, dec.jax, "4", "purple", NAMES, save_path=str(jd / "sample_class_color_4_purple.png"))
    samples_p = viz.generate_class_color_samples(
        ts_, dec.port, "4", "purple", NAMES,
        save_path=str(pd / "sample_class_color_4_purple.png"))
    assert ts_.calls == js.calls and ts_.calls[0][2] == [[4] * 5, [5] * 5]
    np.testing.assert_allclose(samples_p, np.asarray(samples_j), atol=1e-6)
    _same_png(str(pd / "sample_class_color_4_purple.png"),
              str(jd / "sample_class_color_4_purple.png"))
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))
