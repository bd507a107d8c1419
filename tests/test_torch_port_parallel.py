"""The port's mesh (flowerdiff_torch/parallel) against the JAX package's
multi-device tests (tests/test_parallel.py), on gloo process groups of
spawned CPU ranks (tests/torch_port_dist_common.py): 4 ranks for the mesh
shapes and the raise, the 2x2 tensor-parallel forward, the data-parallel
gradient and sampling split over 4 data ranks; 2 ranks for the 1x2
tensor-parallel forward. Each world is one spawned job, started at the top
of the module's fixture, while this process computes the JAX side.

The tensor-parallel denoiser is held to JAX `model.apply` on the same
weights (the bridge's numpy tree) within 2e-5, tests/test_parallel.py's
tolerance, and to the port's replicated forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowerdiff.models import ConditionalLatentDenoiser as JaxDenoiser
from flowerdiff_torch.parallel import (
    all_reduce_mean,
    broadcast_from_rank0,
    create_mesh,
    data_rank,
    data_size,
    latent_denoiser_rules,
    local_rows,
    mesh_size,
    shard_params,
)
from flowerdiff_torch.utils.weights import init_numpy_params
from torch_port_dist_common import (
    DENOISER,
    data_parallel_gradient,
    data_parallel_sample,
    denoiser,
    denoiser_inputs,
    parallel_probe,
    start_ranks,
)
from torch_port_threads import one_thread_per_process  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4-rank and the 2-rank jobs' results, rank by rank."""
    four = start_ranks(parallel_probe, 4, tmp_path_factory.mktemp("four"))
    two = start_ranks(parallel_probe, 2, tmp_path_factory.mktemp("two"))
    return {4: four.join(), 2: two.join()}


@pytest.fixture(scope="module")
def jax_forward():
    z, t, c = denoiser_inputs()
    tree = init_numpy_params("denoiser", seed=1, **DENOISER)
    return np.asarray(JaxDenoiser(**DENOISER).apply(jax.tree.map(jnp.asarray, tree),
                                                   jnp.asarray(z), jnp.asarray(t),
                                                   jnp.asarray(c)))


def test_one_process_mesh_is_none_and_a_larger_one_names_torchrun(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mesh = create_mesh()
    assert mesh is None and create_mesh(data=1, model=1) is None
    assert (mesh_size(mesh), data_size(mesh), data_rank(mesh)) == (1, 1, 0)
    x = torch.arange(6.0)
    assert local_rows(mesh, x) is x and all_reduce_mean(mesh, [x])[0] is x
    broadcast_from_rank0([x])
    assert shard_params(denoiser(DENOISER, 1), mesh, latent_denoiser_rules()) is not None
    for data, model in ((2, 1), (1, 2), (None, 2), (4, 2)):
        with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
            create_mesh(data=data, model=model)


def test_mesh_shapes(ranks):
    for out in ranks[4]:
        assert out["shape_default"] == (4, 1)
        assert out["shape_2x2"] == (2, 2)
        assert out["raise_3x2"] == "mesh 3x2 != 4 ranks"


@pytest.mark.parametrize("world,key", [(2, "tp_1x2"), (4, "tp_2x2")])
def test_tensor_parallel_forward(ranks, jax_forward, world, key):
    """Column-parallel block_fc, downsample and q/k/v, row-parallel out:
    each rank holds half of block_fc_0 (half the rows of its (out, in) weight),
    and the gathered output matches JAX and the replicated forward."""
    z, t, c = (torch.from_numpy(a) for a in denoiser_inputs())
    with torch.no_grad():
        replicated = denoiser(DENOISER, 1)(z, t, c).numpy()
    np.testing.assert_allclose(replicated, jax_forward, atol=2e-5)
    for out in ranks[world]:
        got, local_shape = out[key]
        assert local_shape == (DENOISER["hidden_dims"][0] // 2, DENOISER["hidden_dims"][0])
        np.testing.assert_allclose(got, jax_forward, atol=2e-5)
        np.testing.assert_allclose(got, replicated, atol=2e-5)


def test_data_parallel_gradient_step(ranks):
    """Per-rank gradients of the rank's rows, averaged over 4 data ranks:
    the global-batch gradient, as jit's psum gives it."""
    x = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    w = jnp.ones((8, 8))
    g_ref = np.asarray(jax.grad(lambda w, x: jnp.mean((x @ w) ** 2))(w, jnp.asarray(x)))
    np.testing.assert_allclose(data_parallel_gradient(None), g_ref, atol=1e-6)
    for out in ranks[4]:
        np.testing.assert_allclose(out["grad"], g_ref, atol=1e-6)
        np.testing.assert_array_equal(out["grad"], ranks[4][0]["grad"])


def test_data_parallel_sampling_under_mesh(ranks):
    """A 16-row request split over 4 data ranks, each on its rows of the
    global start and of every step's noise, gathered: equal to the
    one-process run (the JAX test's sharded-against-unsharded check)."""
    whole = data_parallel_sample(None)
    assert whole.shape == (16, 16) and np.isfinite(whole).all()
    for out in ranks[4]:
        np.testing.assert_allclose(out["sample"], whole, atol=1e-4)
