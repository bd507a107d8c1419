"""flowerdiff_torch kernel modules on the CPU (their plain twins) against the
JAX package: the Pallas kernels in interpret mode, `model.apply`, and the
DDPM step math. The CUDA kernels themselves are held against these twins on
the card (chip_smoke.py, tests/test_torch_port_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowerdiff.diffusion import linear_schedule as jax_schedule
from flowerdiff.diffusion.ddpm import p_sample as jax_p_sample
from flowerdiff.kernels.latent_stage import fused_head as jax_fused_head
from flowerdiff.kernels.latent_stage import fused_stage as jax_fused_stage
from flowerdiff.models import ConditionalLatentDenoiser as JaxDenoiser
from flowerdiff_torch.diffusion import linear_schedule
from flowerdiff_torch.kernels.denoiser_apply import make_fast_denoiser
from flowerdiff_torch.kernels.full_sampler import (
    philox4x32_10,
    philox_normal,
    reverse_step,
)
from flowerdiff_torch.kernels.latent_stage import (
    bind_head,
    PIECES,
    SMEM_LIMIT,
    bind_stage,
    fused_head,
    fused_stage,
    pack_stage_weight,
    stage_plan,
)
from flowerdiff_torch.utils.weights import denoiser_from_params, init_numpy_params

# The JAX kernels' own LayerNorm epsilon, passed to the port to match.
JAX_KERNEL_EPS = 1e-5


def _mk(rng, *shape, scale=0.05):
    return rng.normal(size=shape, scale=scale).astype(np.float32)


def _both(arrs, bf16):
    """numpy arrays -> (jax list, torch list); the `bf16` indices are weights,
    bf16 on both sides, (in, out) for JAX and (out, in) for the port."""
    j = [jnp.asarray(a, jnp.bfloat16 if i in bf16 else jnp.float32) for i, a in enumerate(arrs)]
    t = [torch.from_numpy(a.T.copy()).to(torch.bfloat16) if i in bf16
         else torch.from_numpy(a) for i, a in enumerate(arrs)]
    return j, t


@pytest.mark.parametrize("d,d_out", [(128, 128), (128, 256), (256, 128)])
def test_plain_fused_stage_matches_pallas_interpret(d, d_out):
    rng = np.random.default_rng(0)
    b = 8
    arrs = [_mk(rng, b, d), _mk(rng, b, d),
            _mk(rng, d, d), _mk(rng, d), 1 + _mk(rng, d), _mk(rng, d),
            1 + _mk(rng, d), _mk(rng, d),
            _mk(rng, d, d), _mk(rng, d), _mk(rng, d, d), _mk(rng, d),
            _mk(rng, d, d_out), _mk(rng, d_out)]
    j, t = _both(arrs, bf16={2, 8, 10, 12})
    ref = np.asarray(jax_fused_stage(*j, interpret=True))
    got = fused_stage(*t, eps=JAX_KERNEL_EPS).numpy()
    # tolerance of tests/test_kernels.py:44-46
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


def test_plain_fused_stage_row_add_equals_folded_tc():
    rng = np.random.default_rng(1)
    d = 64
    arrs = [_mk(rng, 4, d), _mk(rng, 4, d), _mk(rng, d, d), _mk(rng, d),
            np.ones(d, np.float32), _mk(rng, d), np.ones(d, np.float32), _mk(rng, d),
            _mk(rng, d, d), _mk(rng, d), _mk(rng, d, d), _mk(rng, d),
            _mk(rng, d, d), _mk(rng, d)]
    _, t = _both(arrs, bf16={2, 8, 10, 12})
    row = torch.from_numpy(_mk(rng, d))
    split = fused_stage(*t, row_add=row)
    folded = fused_stage(t[0] + row, *t[1:])
    np.testing.assert_allclose(split.numpy(), folded.numpy(), rtol=0, atol=0)


def test_bound_stage_and_head_equal_unbound():
    """bind_stage / bind_head (weights fixed once, as the sampler uses them)
    compute exactly what fused_stage / fused_head compute."""
    rng = np.random.default_rng(4)
    d, de, lat = 64, 32, 128
    arrs = [_mk(rng, 4, d), _mk(rng, 4, d), _mk(rng, d, d), _mk(rng, d),
            1 + _mk(rng, d), _mk(rng, d), 1 + _mk(rng, d), _mk(rng, d),
            _mk(rng, d, d), _mk(rng, d), _mk(rng, d, d), _mk(rng, d),
            _mk(rng, d, 2 * d), _mk(rng, 2 * d)]
    _, t = _both(arrs, bf16={2, 8, 10, 12})
    row = torch.from_numpy(_mk(rng, d))
    np.testing.assert_array_equal(bind_stage(*t[2:])(t[0], t[1], row_add=row).numpy(),
                                  fused_stage(*t, row_add=row).numpy())
    harrs = [_mk(rng, 4, d), _mk(rng, 4, de), _mk(rng, 4, de), _mk(rng, de, d), _mk(rng, d),
             _mk(rng, de, d), _mk(rng, d), 1 + _mk(rng, d), _mk(rng, d), _mk(rng, d, lat),
             _mk(rng, lat)]
    _, ht = _both(harrs, bf16={3, 5, 9})
    adds = dict(row_add=torch.from_numpy(_mk(rng, d)), rows_add=torch.from_numpy(_mk(rng, 4, d)))
    np.testing.assert_array_equal(bind_head(*ht[3:])(ht[0], ht[1], ht[2], **adds).numpy(),
                                  fused_head(*ht, **adds).numpy())


# The stage kernel's launch plans: the flagship's four stages, hidden
# (256, 512, 1024, 512, 256), and the card tests' other stage shapes.
FLAGSHIP_STAGES = [(256, 512), (512, 1024), (1024, 512), (512, 256)]
CARD_TEST_STAGES = [(64, 64), (128, 256), (256, 64), (1024, 768), (512, 1536)]
# cudaOccupancyMaxActiveClusters for clusters of 16 stage blocks on the
# H100 SXM (chip_smoke.py prints it)
H100_WAVE16 = 7


@pytest.mark.parametrize("rows", [16, 128])
@pytest.mark.parametrize("d,d_out", FLAGSHIP_STAGES + CARD_TEST_STAGES)
def test_stage_plan_fits_the_kernel(d, d_out, rows):
    plan = stage_plan(d, d_out, rows, H100_WAVE16)
    assert plan.smem <= SMEM_LIMIT == 232_448
    assert plan.cluster in (1, 2, 4, 8, 16)
    assert stage_plan(d, d_out, rows) == stage_plan(d, d_out, 16)  # no limit: one wave
    # clusters of 16 only for the wide stages, and only where 16-row tiles
    # fit in one wave of them; else the whole-row kernel on clusters of 8
    if d == 1024 and rows == 128:
        sm = max(d, d_out) // 8
        whole = 4 * (16 * (2 * d + 2 * sm) + 16 * 64) + 2 * 16 * (d + 32)
        assert plan == (8, 0, 0, whole) and d_out % 64 == 0
        return
    assert plan.cluster == (16 if d == 1024 else 8)
    for n in (d, d_out):  # each block's column slice is whole n8 tiles
        assert n % plan.cluster == 0 and (n // plan.cluster) % 8 == 0
    assert plan.slots >= 2
    assert d % plan.chunk == 0 and plan.chunk % 16 == 0  # whole k16 steps
    # A block's chunk of a product is one bulk copy a piece of its packed
    # weight (PIECES / cluster pieces): piece j's rows, k's from kc chunk, at
    # byte ((j nk + kc) R) stride of the packed tensor, R = N / PIECES rows of
    # stride slot_row_bytes, into a slot after the mbarriers.
    stride, nk = plan.slot_row_bytes(), d // plan.chunk
    slot_rows = max(d, d_out) // plan.cluster
    assert stride % 16 == 0 and stride >= 2 * plan.chunk
    for n in (d, d_out):
        piece = n // PIECES * stride
        assert piece % 16 == 0 and (PIECES // plan.cluster) * piece <= slot_rows * stride
        for j in range(PIECES):
            for kc in range(nk):
                assert (j * nk + kc) * piece % 16 == 0
        for slot in range(plan.slots):
            for j in range(PIECES // plan.cluster):
                assert (128 + slot * slot_rows * stride + j * piece) % 16 == 0
    # ldmatrix reads eight rows at once: rows 16 bytes apart modulo 128
    # bytes hit eight different bank groups, in a slot and in the operand.
    assert stride % 128 == 16 and 2 * (d + 8) % 128 == 16
    # the ring and the fixed buffers add up to the plan's shared memory
    sd = d // plan.cluster
    fixed = 128 + 2 * 4 * 16 * sd + 2 * 2 * 16 * (d + 8) + 2 * 8 * 16 * 16 + 4 * 8 * 16 * 8
    assert plan.smem == fixed + plan.slots * slot_rows * stride


def _ring_readers(plan, ncols):
    """Which of the 8 compute warps read the ring in a product of `ncols`
    columns a block: the split of csrc/latent_stage.cu::ring_gemm (n8 tiles,
    1, 2 or 4 a warp; below 8 tiles, `wpt` warps a tile split the k steps)."""
    tiles, steps = ncols // 8, plan.chunk // 16
    tpw = 1 if tiles <= 8 else 2 if tiles <= 16 else 4
    wpt = min(8 // tiles, steps) if tiles < 8 else 1
    return [(w // wpt) * tpw < tiles for w in range(8)]


def _ring_faults(plan, d, d_out, idle_waits=True):
    """Play the weight ring of csrc/latent_stage.cu::Ring for one launch and
    return what went wrong: a read of a slot that a refill had overwritten,
    or a wait that never ends. Chunk q of the 4 d / chunk lives in slot q %
    slots; a copy lands at once; `full` completes a phase at each copy,
    `empty` at each 8th arrival; a wait on parity P passes once the phase of
    parity P has completed, as mbarrier.try_wait.parity does. The compute
    warps that read nothing run first, the producer next, the readers last:
    the order in which an early arrival does harm. `idle_waits` False plays
    warps that read nothing arriving without waiting for the chunk."""
    nk, slots = d // plan.chunk, plan.slots
    total = 4 * nk
    cols = [d // plan.cluster] * 3 + [d_out // plan.cluster]
    full, empty, arrived, held = [0] * slots, [0] * slots, [0] * slots, [None] * slots
    faults = []

    def warp(w):
        for p in range(4):
            reads = _ring_readers(plan, cols[p])[w]
            for q in range(p * nk, (p + 1) * nk):
                if reads or idle_waits:
                    yield "wait_full", q
                if reads:
                    yield "read", q
                yield "arrive", q
            yield "sync", p

    def producer():
        for q in range(min(slots, total)):
            yield "issue", q
        for p in range(4):
            for q in range(p * nk, (p + 1) * nk):
                if q + slots < total:
                    yield "wait_empty", q
                    yield "issue", q + slots
            yield "sync", p

    threads = [warp(w) for w in range(8)] + [producer()]
    pending = [next(t) for t in threads]

    def step(i):  # run thread i's next operation unless it must wait
        op, q = pending[i]
        s, parity = q % slots, (q // slots) & 1
        if op == "wait_full" and full[s] & 1 == parity:
            return False
        elif op == "wait_empty" and empty[s] & 1 == parity:
            return False
        elif op == "issue":
            held[s] = q
            full[s] += 1
        elif op == "read" and held[s] != q:
            faults.append(f"chunk {q} overwritten by chunk {held[s]} before it was read")
        elif op == "arrive":
            arrived[s] += 1
            if arrived[s] == 8:
                arrived[s], empty[s] = 0, empty[s] + 1
        pending[i] = next(threads[i], None)
        return True

    while any(pending):
        if all(op == "sync" for op, _ in pending):  # the block barrier after a product
            pending = [next(t, None) for t in threads]
            continue
        live = [i for i, (op, _) in enumerate(pending) if op != "sync"]
        order = ([i for i in live if i < 8 and pending[i][0] != "read"] + [8]
                 + [i for i in live if pending[i][0] == "read"])
        if not any(i in live and step(i) for i in order):
            return faults + [f"waits forever at {[pending[i] for i in live]}"]
    return faults


def _accepted_plans():
    """Every (d, d_out) the stage kernel takes, planned at 16 and at 128 rows
    on the H100 SXM; one of each distinct ring protocol (slots, chunks a
    product, reading warps of each product) of the plans that use the ring."""
    seen = {}
    for d in range(64, 1025, 64):
        for d_out in range(16, 4097, 16):
            for rows in (16, 128):
                try:
                    plan = stage_plan(d, d_out, rows, H100_WAVE16)
                except ValueError:
                    continue
                if not plan.slots:  # the whole-row kernel: no ring
                    continue
                cols = [d // plan.cluster] * 3 + [d_out // plan.cluster]
                key = (plan.slots, d // plan.chunk,
                       tuple(tuple(_ring_readers(plan, n)) for n in cols))
                seen.setdefault(key, (plan, d, d_out))
    return list(seen.values())


def test_stage_ring_never_overwrites_a_chunk_being_read():
    plans = _accepted_plans()
    assert len(plans) > 10
    for plan, d, d_out in plans:
        assert _ring_faults(plan, d, d_out) == [], (plan, d, d_out)
    # Idle warps that arrive without waiting would let a refill overwrite a
    # chunk still being read where a product has idle warps and more chunks
    # than slots: the card tests' (512, 1536) at 128 rows is such a plan.
    plan = stage_plan(512, 1536, 128, H100_WAVE16)
    readers = _ring_readers(plan, 1536 // plan.cluster)
    assert not all(readers) and 512 // plan.chunk > plan.slots
    assert _ring_faults(plan, 512, 1536, idle_waits=False) != []


@pytest.mark.parametrize("chunk", [64, 128])
def test_pack_stage_weight_layout(chunk):
    """Piece j, chunk kc of the packed weight holds rows j R .. (j + 1) R and
    k's kc chunk .. (kc + 1) chunk of the (out, in) weight, each row followed
    by 8 zeros; the bytes of a (piece, chunk) are contiguous."""
    n, k = 96, 256
    w = torch.from_numpy(_mk(np.random.default_rng(7), n, k)).to(torch.bfloat16)
    packed = pack_stage_weight(w, chunk)
    r = n // PIECES
    assert packed.shape == (PIECES, k // chunk, r, chunk + 8) and packed.is_contiguous()
    for j in range(PIECES):
        for kc in range(k // chunk):
            assert torch.equal(packed[j, kc, :, :chunk],
                               w[j * r:(j + 1) * r, kc * chunk:(kc + 1) * chunk])
    assert not packed[..., chunk:].any()


@pytest.mark.parametrize("d,d_out", [(96, 64), (2048, 512), (64, 4096), (256, 100),
                                     (1024, 4), (0, 64)])
def test_stage_plan_rejects_widths_the_kernel_cannot_take(d, d_out):
    with pytest.raises(ValueError):
        stage_plan(d, d_out)


def test_plain_fused_head_matches_pallas_interpret():
    rng = np.random.default_rng(2)
    b, dl, de, lat = 8, 128, 128, 128
    arrs = [_mk(rng, b, dl), _mk(rng, b, de), _mk(rng, b, de),
            _mk(rng, de, dl), _mk(rng, dl), _mk(rng, de, dl), _mk(rng, dl),
            1 + _mk(rng, dl), _mk(rng, dl), _mk(rng, dl, lat), _mk(rng, lat)]
    j, t = _both(arrs, bf16={3, 5, 9})
    ref = np.asarray(jax_fused_head(*j, interpret=True))
    got = fused_head(*t, eps=JAX_KERNEL_EPS).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("variant", ["v1", "v2", "v3"])
def test_fast_denoiser_matches_flax(variant):
    kw = dict(latent_dim=128, hidden_dims=(128, 256, 128), time_emb_dim=128,
              num_classes=11)
    if variant == "v2":
        kw["global_skip"] = True
    if variant == "v3":
        kw.update(shared_cond_proj=False, num_colors=4)
    tree = init_numpy_params("denoiser", seed=1, **kw)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    t = np.array([0, 10, 100, 500, 999, 1, 2, 3], np.int32)
    c = (np.arange(8) % 11).astype(np.int32)
    col = (np.arange(8) % 4).astype(np.int32)
    args = (x, t, c, col) if variant == "v3" else (x, t, c)
    ref = np.asarray(JaxDenoiser(**kw).apply(jax.tree.map(jnp.asarray, tree),
                                             *map(jnp.asarray, args)))
    fast = make_fast_denoiser(denoiser_from_params(tree, device="cpu", **kw))
    got = fast(*[torch.from_numpy(a if a.dtype == np.float32 else a.astype(np.int64))
                 for a in args]).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-2 * float(np.abs(ref).max()))


def test_philox_known_answers():
    """Random123's published Philox4x32-10 test vectors."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        got = philox4x32_10(torch.tensor([ctr[0]]), *ctr[1:], *key)
        assert tuple(int(v) for v in got) == want


def test_philox_normal_moments():
    z = philox_normal(200_000, step=3, key=(11, 22))
    assert abs(float(z.mean())) < 0.01
    assert abs(float(z.var()) - 1.0) < 0.01
    assert not torch.equal(z[:1000], philox_normal(1000, step=4, key=(11, 22)))


@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("clip", [None, 1.0])
def test_plain_reverse_step_matches_jax_p_sample(guided, clip):
    """reverse_step's twin == JAX p_sample fed the same eps combination and
    the same noise (the twin's Philox draws, passed as numpy)."""
    sched_j, sched_t = jax_schedule(50), linear_schedule(50)
    rng = np.random.default_rng(3)
    b, lat, s = 6, 16, 3.5
    x = rng.standard_normal((b, lat)).astype(np.float32)
    eps = rng.standard_normal((2 * b if guided else b, lat)).astype(np.float32)
    for t in (0, 1, 37):
        key = (5, 9)
        coefs = (float(sched_t.alpha[t]), float(sched_t.alpha_bar[t]), float(sched_t.beta[t]))
        got = reverse_step(torch.from_numpy(eps), torch.from_numpy(x), t, coefs,
                           guidance_scale=s if guided else None, clip_x0=clip, key=key)
        e = eps[b:] + s * (eps[:b] - eps[b:]) if guided else eps
        noise = philox_normal(b * lat, t, key).reshape(b, lat).numpy()
        ref = jax_p_sample(sched_j, jnp.asarray(x), jnp.full((b,), t, jnp.int32),
                           jnp.asarray(e), jnp.asarray(noise), clip)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_plain_reverse_step_noise_closed_form():
    """Zero eps from x = 0: x_{t-1} = x_t / sqrt(a_t) + sqrt(b_t) z_t, so
    the final variance follows v <- v / a_t + b_t (none added at t = 0)."""
    sched = linear_schedule(20)
    x = torch.zeros(64, 128)
    eps = torch.zeros_like(x)
    for t in range(19, -1, -1):
        coefs = (float(sched.alpha[t]), float(sched.alpha_bar[t]), float(sched.beta[t]))
        x = reverse_step(eps, x, t, coefs, key=(3, 4))
    v = 0.0
    for t in range(19, 0, -1):
        v = v / float(sched.alpha[t]) + float(sched.beta[t])
    v = v / float(sched.alpha[0])
    np.testing.assert_allclose(float(x.var()), v, rtol=0.1)
    assert abs(float(x.mean())) < 5 * (v / x.numel()) ** 0.5
