"""The yardstick's arithmetic: the card's peaks, and the operations and bytes
of the served work, from the configuration's shapes alone (never from the
port's objects), so a roofline reads the same work whatever implements it.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense.
"""
from __future__ import annotations

BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
STEP_F32_OPS = 60  # the reverse step's f32 operations an element (CFG, clip, mean, noise)


def _hidden(den: dict):
    return list(den["hidden_dims"])


def denoiser_row_flops(den: dict) -> int:
    """Multiply-adds x 2 of one denoiser row at one step: the latent
    projection, each stage's block, v, out and downsample products, the head
    (and the v2 skip's product)."""
    lat, hid = den["latent_dim"], _hidden(den)
    flops = 2 * lat * hid[0] + 2 * hid[-1] * lat
    for d, dout in zip(hid[:-1], hid[1:]):
        flops += 2 * d * (3 * d + dout)
    if den["global_skip"]:
        flops += 2 * lat * lat
    return flops


def param_bytes(den: dict) -> int:
    """Every parameter of the denoiser once: matrices as bf16, vectors f32
    (the time and condition paths' too: a slight over-count)."""
    lat, hid, temb, ncls = den["latent_dim"], _hidden(den), den["time_emb_dim"], den["num_classes"]
    mats = 2 * temb * 2 * temb + ncls * temb + 2 * temb * temb + hid[0] * lat
    vecs = 2 * temb + temb + 2 * temb + hid[0]
    for d, dout in zip(hid[:-1], hid[1:]):
        cond = 1 if den["shared_cond_proj"] else 2
        mats += cond * d * temb + d * d + 4 * d * d + dout * d
        vecs += cond * d + d + 4 * d + 4 * d + dout
    mats += 2 * hid[-1] * temb + lat * hid[-1]
    vecs += 2 * hid[-1] + 2 * hid[-1] + lat + 1
    return 2 * mats + 4 * vecs


def process_bound_s(cfg: dict, bucket: int) -> float:
    """The least time of one launch of the reverse process over a chunk of
    `bucket` samples: the larger of its bytes (every weight, the time tables,
    the condition rows and x read once, x written once) over HBM and its
    operations (the T steps' bf16 products over the rows as launched, the
    projection once a sample, plus the reverse step's f32 work) over the
    peaks."""
    den, steps = cfg["denoiser"], cfg["schedule"]["n_steps"]
    guided = cfg["sampler"]["guidance_scale"] is not None
    rows = bucket * (2 if guided else 1)
    lat, hid = den["latent_dim"], _hidden(den)
    n_bytes = (param_bytes(den) + 4 * steps * sum(hid) + 4 * rows * sum(hid)
               + 2 * 4 * bucket * lat)
    flops = 2 * bucket * lat * hid[0] + 2 * rows * hid[-1] * lat
    for d, dout in zip(hid[:-1], hid[1:]):
        flops += 2 * rows * d * (3 * d + dout)
    if den["global_skip"]:
        flops += 2 * bucket * lat * lat
    t_ops = steps * (flops / BF16_FLOP_PER_S + STEP_F32_OPS * bucket * lat / F32_FLOP_PER_S)
    return max(n_bytes / HBM_BYTES_PER_S, t_ops)


def _conv_flops(cin: int, cout: int, k: int, pixels: int) -> int:
    return 2 * cin * cout * k * k * pixels


def _residual_flops(c: int, side: int) -> int:
    px = side * side
    return (2 * _conv_flops(c, c, 3, px) + 2 * (2 * c * (c // 8))
            + _conv_flops(2, 1, 7, px))


def decoder_flops(dec: dict) -> int:
    """Multiply-adds x 2 of one decoded image: fc1, fc2, every convolution and
    transposed convolution, the channel gates' two products."""
    ch, base = dec["channels"], dec["base_size"]
    flat = ch[-1] * base * base
    flops = 2 * dec["latent_dim"] * dec["head_width"] + 2 * dec["head_width"] * flat
    side, prev = base, ch[-1]
    n = len(ch) - 1
    flops += _residual_flops(ch[-1], side)
    for i in range(n, 0, -1):
        c = ch[i - 1]
        # each input pixel scatters prev x c x 4 x 4 products
        flops += 2 * prev * c * 16 * side * side
        side *= 2
        if i > 1:
            flops += _residual_flops(c, side)
        prev = c
    mid = max(4, ch[0] // 2)
    flops += _conv_flops(prev, mid, 3, side * side) + _conv_flops(mid, dec["out_channels"], 3,
                                                                  side * side)
    return flops


def image_flops(cfg: dict) -> int:
    """Model operations of one delivered image: T steps of the denoiser over
    its rows (two when guided), then one decode."""
    rows = 2 if cfg["sampler"]["guidance_scale"] is not None else 1
    return (rows * cfg["schedule"]["n_steps"] * denoiser_row_flops(cfg["denoiser"])
            + decoder_flops(cfg["decoder"]))
