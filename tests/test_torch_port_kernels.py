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
    ROW_CHOICES,
    SMEM_LIMIT,
    WAVE_BLOCKS,
    bind_head,
    bind_stage,
    chunk_tiles,
    fused_head,
    fused_stage,
    stage_cost_us,
    stage_plan,
    stage_plans,
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
# The row counts of the sampler's stage launches: the 8 and 64 buckets with
# CFG (16, 128) and the unguided v1 service's 8, 32 and 64.
SAMPLER_ROWS = (8, 16, 32, 64, 128)


def _slices(d, d_out, plan):
    return d // plan.cols, d_out // plan.cols


def _chunks(d, d_out, plan):
    """(k64 tiles a chunk, chunks) of the d-wide products and of Wd's."""
    sd, so = _slices(d, d_out, plan)
    kbd, kbo = chunk_tiles(sd, d), chunk_tiles(so, d)
    return (kbd, d // 64 // kbd), (kbo, d // 64 // kbo)


def _layout(d, d_out, plan):
    """Byte offsets of csrc/latent_stage.cu::StageLayout from the aligned base."""
    sd, so = _slices(d, d_out, plan)
    (kbd, _), (kbo, _) = _chunks(d, d_out, plan)
    slot = max(kbd * sd, kbo * so) * 128
    q = plan.slots * slot
    stats = q + plan.qbufs * plan.rows * d * 2
    red = stats + 2 * plan.cols * plan.rows * 8
    mr = red + 2 * 2 * 4 * plan.rows * 4  # row sums: [pass][warpgroup][warp][row]
    vec = mr + plan.rows * 8  # the block's slices of the 8 vectors
    part = vec + -(-(7 * sd + so) * 4 // 16) * 16  # both warpgroups' partial sums
    bars = part + 2 * 128 * -(-max(sd, so) // 64) * (plan.rows // 2) * 4
    total = bars + (2 * plan.slots + 8) * 8
    # a chunk's reads reach its last k64 tile's last m64 tile, 64 lines
    reach = max((kb - 1) * n * 128 + -(-n // 64) * 8192 for n, kb in ((sd, kbd), (so, kbo)))
    return dict(slot=slot, q=q, stats=stats, red=red, mr=mr, vec=vec, part=part, bars=bars,
                reach=reach,
                total=total + max(0, reach - slot - (total - q)))


@pytest.mark.parametrize("rows", [16, 128])
@pytest.mark.parametrize("d,d_out", FLAGSHIP_STAGES + CARD_TEST_STAGES)
def test_stage_plan_fits_the_kernel(d, d_out, rows):
    plan = stage_plan(d, d_out, rows)
    sd, so = _slices(d, d_out, plan)
    # clusters of at most 16 blocks cover the rows, in one wave of the card
    assert plan.cols <= 16 and plan.rows in ROW_CHOICES
    assert plan.tiles * plan.rows >= rows
    assert plan.tiles * plan.cols <= WAVE_BLOCKS
    # column slices: whole 16-byte units of an operand, a TMA box's <= 256
    # lines, at most the m64 tiles a thread's 64 accumulators take
    for n in (sd, so):
        assert n * plan.cols in (d, d_out) and n % 8 == 0 and n <= 256
        assert -(-n // 64) * plan.rows // 2 <= 64
    # the ring and the fixed parts add up to the plan's shared memory, which
    # fits, and the last slot's reads stay inside it
    lay = _layout(d, d_out, plan)
    assert plan.smem == 1024 + lay["total"] <= SMEM_LIMIT == 232_448
    assert lay["q"] - lay["slot"] + lay["reach"] <= lay["total"]
    (kbd, nkd), (kbo, nko) = _chunks(d, d_out, plan)
    assert 2 <= plan.slots <= min(32, 3 * nkd + nko)
    # a chunk is one TMA box of at most 32 KB; every buffer the swizzled
    # operands use starts on 1024 bytes: each slot, each k64 tile of a chunk
    # (slice lines of 128 bytes), each m64 tile in it, each operand buffer,
    # each k64 chunk of it, each warpgroup's rows
    for n, kb in ((sd, kbd), (so, kbo)):
        assert kb * n * 128 <= 32768 and (d // 64) % kb == 0 and (n * 128) % 1024 == 0
    assert lay["slot"] % 1024 == 0 and lay["q"] % 1024 == 0
    assert (plan.rows * d * 2) % 1024 == 0 and (plan.rows * 128) % 1024 == 0

    # the cheapest of the plans the kernel takes
    cost = stage_cost_us(d, d_out, plan)
    assert all(stage_cost_us(d, d_out, other) >= cost for other in stage_plans(d, d_out, rows))


@pytest.mark.parametrize("rows", SAMPLER_ROWS)
def test_stage_plan_takes_every_sampler_row_count_in_one_wave(rows):
    """Every flagship stage at every row count the sampler launches: the
    plan covers its rows with at most WAVE_BLOCKS blocks, one wave of the
    H100's clusters; the same plan each time."""
    for d, d_out in FLAGSHIP_STAGES:
        plan = stage_plan(d, d_out, rows)
        assert plan in stage_plans(d, d_out, rows)
        assert plan.tiles * plan.rows >= rows
        assert plan.tiles * plan.cols <= WAVE_BLOCKS
        assert plan == stage_plan(d, d_out, rows)
    # above 128 rows the 128-row plan repeats over clusters along the rows
    big = stage_plan(1024, 512, 1000)
    base = stage_plan(1024, 512, 128)
    assert big._replace(tiles=base.tiles) == base
    assert big.tiles * big.rows >= 1000 > (big.tiles - 1) * big.rows


def _boxes(d, d_out, plan):
    """Each chunk the producers of one cluster issue, as
    csrc/latent_stage.cu::stage_kernel's `issue` computes it: (column slice,
    product, first k64 tile, first weight row, box lines, box k64 tiles)."""
    sd, so = _slices(d, d_out, plan)
    (kbd, nkd), (kbo, nko) = _chunks(d, d_out, plan)
    for c in range(plan.cols):
        for q in range(3 * nkd + nko):
            p = q // nkd if q < 3 * nkd else 3
            kc = q - p * nkd if p < 3 else q - 3 * nkd
            n, kb = (sd, kbd) if p < 3 else (so, kbo)
            yield c, p, kc * kb, c * n, n, kb


@pytest.mark.parametrize("d,d_out,rows", [(256, 512, 128), (1024, 512, 128), (1024, 512, 16),
                                          (192, 24, 40), (512, 1536, 128), (1024, 3968, 16)])
def test_stage_tensor_map_boxes_read_each_weight_byte_once_a_cluster(d, d_out, rows):
    """The tensor maps view each (out, in) bf16 weight, row stride d x 2
    bytes (a multiple of 16), as (64 k's, rows, d / 64 k64 tiles) and read
    boxes of (64, a column slice's rows, a chunk's k64 tiles): 128 bytes a
    line (the swizzle's span), every box dimension at most 256. Over one
    cluster's launch the issued boxes tile each of Wb, Wv, Wo (d x d) and Wd
    (d_out x d) exactly once, each landing in a slot that holds it."""
    plan = stage_plan(d, d_out, rows)
    assert (d * 2) % 16 == 0
    lay = _layout(d, d_out, plan)
    seen = [np.zeros((d, d), np.int32) for _ in range(3)] + [np.zeros((d_out, d), np.int32)]
    for c, p, t0, r0, lines, kb in _boxes(d, d_out, plan):
        assert 1 <= lines <= 256 and 1 <= kb <= 256 and kb * lines * 128 <= lay["slot"]
        assert (t0 + kb) * 64 <= d and r0 + lines <= seen[p].shape[0]
        seen[p][r0:r0 + lines, 64 * t0:64 * (t0 + kb)] += 1
    assert all((s == 1).all() for s in seen)


def _accepted_before(d, d_out):
    """The widths the stage kernel took before its Hopper redesign: the
    16-row plan of the earlier ring kernel (clusters of 16 for the wide
    stages, else 8; column slices of whole n8 tiles, at most 256 wide; its
    shared memory), with the whole-row kernel's limits where it had
    clusters of 16 (d_out a multiple of 64 up to 4096)."""
    if d <= 0 or d % 64 or d > 1024 or d_out <= 0 or d_out % 16:
        return False
    cluster = 1 << (min(16, d // 8, max(d_out // 8, 1)).bit_length() - 1)
    if cluster == 16 and (3 * d + d_out) * d * 2 // 8 <= 1 << 19:
        cluster = 8
    for n in (d, d_out):
        if n % (8 * cluster) or n // cluster > 256:
            return False
    sd, sm = d // cluster, max(d, d_out) // cluster
    for chunk in (256, 128, 64):
        if d % chunk:
            continue
        fixed = 128 + 4 * 2 * 16 * sd + 2 * 2 * 16 * (d + 8) + 8 * 2 * 16 * 16 + 4 * 8 * 16 * 8
        slot = sm * (2 * chunk + 16)
        if min(8, 4 * d // chunk, (232_448 - fixed) // slot) >= 2:
            break
    else:
        return False
    if cluster == 16:  # the whole-row kernel's clusters of 8
        whole = 4 * (16 * (2 * d + 2 * max(d, d_out) // 8) + 16 * 64) + 2 * 16 * (d + 32)
        return d_out % 64 == 0 and d_out <= 4096 and whole <= 232_448
    return True


def test_stage_plan_accepts_every_width_it_accepted_before():
    before = [(d, o) for d in range(64, 1025, 64) for o in range(16, 4097, 16)
              if _accepted_before(d, o)]
    assert len(before) == 479 and (1024, 512) in before and (512, 4096) in before
    for d, d_out in before:
        for rows in (1, 8, 16, 100, 128, 300):
            plan = stage_plan(d, d_out, rows)
            assert plan.smem <= SMEM_LIMIT, (d, d_out, rows, plan)


def _ring_faults(plan, d, d_out, order, arrivals=8):
    """Play the weight ring of csrc/latent_stage.cu for one block of one
    launch, and return what went wrong: a box that landed in a slot whose
    chunk a warp was still reading, a read of a slot holding another chunk,
    or a wait that never ends. The stream is each d-wide product's chunks,
    then Wd's.

    The block has 8 consumer warps (two warpgroups, each multiplying the
    chunk's k64 tiles of its parity: every warp reads every chunk) and a
    producer. Chunk q lives in slot q % slots. The producer issues the
    first `slots` chunks at once; from then on it waits for the `empty`
    phase of chunk q - slots, then expects chunk q's bytes on its `full`
    mbarrier and issues the box, which lands at once. `full` completes
    once its expectation and the bytes are both in; `empty` once
    `arrivals` warps arrived (the kernel counts 8). A consumer warp waits
    for chunk q and reads it until its next chunk has been issued (the
    kernel's wgmma_wait_one), then releases it, unless no refill follows
    (q + slots >= total). A wait on parity P passes once the phase of
    parity P has completed, as mbarrier.try_wait.parity does. `order` ranks
    the threads for the scheduler: the lowest-ranked thread that can move,
    moves."""
    slots = plan.slots
    (_, nkd), (_, nko) = _chunks(d, d_out, plan)
    firsts = [0, nkd, 2 * nkd, 3 * nkd, 3 * nkd + nko]  # each product's first chunk
    total = firsts[-1]
    full_ph, expect, landed = [0] * slots, [False] * slots, [False] * slots
    held, empty_ph, arrived = [None] * slots, [0] * slots, [0] * slots
    reading = {}  # slot -> the warps reading it
    faults = []

    def settle(s):
        if expect[s] and landed[s]:
            expect[s] = landed[s] = False
            full_ph[s] += 1

    def consumer(w):
        for p in range(4):
            last = None
            for q in range(firsts[p], firsts[p + 1]):
                yield "wait_full", q
                yield "read", q
                if last is not None:
                    yield "release", last
                last = q
            yield "release", last

    def producer():
        for q in range(total):
            if q >= slots:
                yield "wait_empty", q - slots
            yield "expect", q
            yield "land", q

    threads = [consumer(w) for w in range(8)] + [producer()]
    pending = [next(gen, None) for gen in threads]

    def step(i):
        op, q = pending[i]
        s, parity = q % slots, (q // slots) & 1
        if op == "wait_full" and full_ph[s] & 1 == parity:
            return False
        if op == "wait_empty" and empty_ph[s] & 1 == parity:
            return False
        if op == "expect":
            expect[s] = True
            settle(s)
        elif op == "land":
            if reading.get(s):
                faults.append(f"chunk {q} landed in slot {s} while chunk {held[s]} was being read")
            held[s] = q
            landed[s] = True
            settle(s)
        elif op == "read":
            if held[s] != q:
                faults.append(f"warp {i} read chunk {q} but slot {s} holds {held[s]}")
            reading.setdefault(s, set()).add(i)
        elif op == "release":
            reading.get(s, set()).discard(i)
            if q + slots < total:
                arrived[s] += 1
                if arrived[s] == arrivals:
                    arrived[s] = 0
                    empty_ph[s] += 1
        pending[i] = next(threads[i], None)
        return True

    while any(p is not None for p in pending):
        live = [i for i in order if pending[i] is not None]
        if not any(step(i) for i in live):
            return faults + [f"waits forever at {[pending[i] for i in live]}"]
    return faults


def _ring_orders(seed):
    """Scheduler orders of the block's threads: the producer first and the
    readers last (an early release does the most harm), one warpgroup
    ahead of the producer and the other behind it, and a random one."""
    rng = np.random.default_rng(seed)
    return [[8] + list(range(8)), [0, 1, 2, 3, 8, 4, 5, 6, 7], list(rng.permutation(9))]


def _ring_protocols():
    """One (plan, d, d_out) of each distinct ring protocol (slots, chunks of
    each product) over every plan the kernel takes for every width at every
    row count up to 128."""
    seen = {}
    for d in range(64, 1025, 64):
        for d_out in range(8, 4097, 8):
            for rows in ROW_CHOICES:
                for plan in stage_plans(d, d_out, rows):
                    key = (plan.slots,) + tuple(n for _, n in _chunks(d, d_out, plan))
                    seen.setdefault(key, (plan, d, d_out))
    return list(seen.values())


def test_stage_ring_never_overwrites_a_chunk_being_read():
    protocols = _ring_protocols()
    assert len(protocols) > 40
    assert any(3 * nkd + nko > plan.slots
               for plan, d, d_out in protocols for (_, nkd), (_, nko) in [_chunks(d, d_out, plan)])
    for i, (plan, d, d_out) in enumerate(protocols):
        for order in _ring_orders(i):
            assert _ring_faults(plan, d, d_out, order) == [], (plan, d, d_out, order)
    # The model catches a broken protocol: an `empty` mbarrier that counts
    # one warpgroup's four warps lets the producer refill a slot that the
    # other warpgroup still reads, where chunks outnumber slots.
    plan = stage_plan(1024, 512, 128)
    (_, nkd), (_, nko) = _chunks(1024, 512, plan)
    assert 3 * nkd + nko > plan.slots
    one_group_behind = _ring_orders(0)[1]
    assert _ring_faults(plan, 1024, 512, one_group_behind) == []
    assert _ring_faults(plan, 1024, 512, one_group_behind, arrivals=4) != []


# (d_out past MAX_WIDTH: a d_out past 4096 now runs Wd in column passes)
@pytest.mark.parametrize("d,d_out", [(96, 64), (2112, 512), (64, (1 << 22) + 8), (256, 100),
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
