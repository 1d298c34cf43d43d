"""K3's plan and the index arithmetic of its kernels, on the CPU.

The kernels themselves run only on the card (``chip_smoke.py`` phase 9
holds them to the plain version there); what surrounds them is Python or
mirrors it, and is tested here:

  * ``ops/conv_int8.plan`` routes every int8-eligible class of the fast
    rollout and ``chip_smoke.py``'s edge and ties cases to a kernel and a
    tiling that covers the output (the ring stages are the kernel's own,
    held to the shared memory by its static_asserts);
  * an emulation of the ``wgmma`` kernel's walk (its CTAs, its K units
    from ``wgmma_units`` / ``unit_origin``, its TMA boxes with
    out-of-bounds reads as zeros, the descriptors' kw and k32 offsets, the
    epilogue's clips at w and co) equals ``accumulate_plain`` exactly: each
    product of integers is exact in f64 (|sum| < 2^53) and the sums are
    int64;
  * the ``packed`` kernel's weight layout (tap-major, the tap's channels
    rounded up to 4, zeros in every padding byte), and an emulation of its
    walk (its persistent CTAs' work items from ``packed_item_origin``, one
    TMA box of [3 kt][3 kh][66 px][16 B] each with out-of-bounds reads as
    zeros, the K row packed tap by tap, unwritten padding bytes of A left as
    garbage, the epilogue's clips at w and co) equals ``accumulate_plain``
    exactly, in ``full``, ``init`` and ``cont``;
  * the quantise step rounds half to even: ``quantize_input_k3`` equals
    deepv_tpu's x8 (captured from its ``conv3d_int8``), channels-last, on
    inputs built to tie (amax 127, so sx = 1 and x / sx = x).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepv_tpu.ops import conv_int8 as jci

import chip_smoke
from deepv_tpu_torch.ops import conv_int8 as tci

torch.set_num_threads(1)

@pytest.fixture(scope="module")
def convs():
    """100 -> 256 (ci_pad 128, two 128-channel tiles) and 100 -> 3 (one
    16-channel tile, 13 of it padding) convs with their int8 buffers, and x
    [2, 100, 4, 3, w] f32 from a numpy seed at w = 136 (a 256-pixel CTA
    with a tail) and w = 20 (a 128-pixel CTA)."""
    rng = np.random.default_rng(0)
    convs = {}
    for co in (256, 3):
        conv = torch.nn.Conv3d(100, co, 3).requires_grad_(False)
        conv.weight.copy_(torch.from_numpy((rng.standard_normal((co, 100, 3, 3, 3)) * 0.05)
                                           .astype(np.float32)))
        convs[co] = tci.quantize_conv_weights(conv)
    xs = {w: torch.from_numpy(rng.standard_normal((2, 100, 4, 3, w)).astype(np.float32))
          for w in (136, 20)}
    return convs, xs


CASES = [c + (1,) for c in chip_smoke.K3_CASES] + list(chip_smoke.K3_EDGE_CASES)


@pytest.mark.parametrize("case", CASES, ids=[f"{c[2]}-{c[3]}-{c[1]}-w{c[5]}" for c in CASES])
def test_plan_routes_every_class(case):
    """wgmma for ci > 16 (ci_pad a multiple of 128; 128- or 16-channel
    CTAs), packed for ci <= 16 (conv_in, ci = 3; the 3 -> 3 edge); the
    grid covers every output pixel and channel (the ring stages are the
    kernels', checked by their static_asserts)."""
    layer, mode, ci, co, h, w, n, b = case
    pl = tci.plan(ci, co, h, w, b, n)
    assert pl.kernel == ("wgmma" if ci > 16 else "packed"), (layer, pl)
    assert pl.bn == (128 if co % 128 == 0 else 16)
    assert pl.grid[1] == -(-co // pl.bn)
    assert pl.segs * pl.bm >= w > (pl.segs - 1) * pl.bm
    if pl.kernel == "wgmma":
        assert tci.ci_pad_of(ci) % tci.WG_CHUNK == 0 and pl.grid[2] == b * n
        assert pl.mb == (2 if w > 128 else 1) and pl.bm == 128 * pl.mb
        assert pl.grid[0] == h * pl.segs
    else:
        items = tci.packed_items(pl, h, b, n)
        assert tci.ci_pad_of(ci) == tci.CI_STEP and pl.bm == tci.PACKED_BM
        assert pl.grid[2] == 1 and 1 <= pl.grid[0] <= min(items, tci.SMS)
        origins = {tci.packed_item_origin(pl, h, n, i) for i in range(items)}
        assert origins == {(bi, to, hh, s * pl.bm) for bi in range(b) for to in range(n)
                           for hh in range(h) for s in range(pl.segs)}


def tma_box(x8, c, w, h, t, b, box_w):
    """TMA's tiled load of a [box_w pixels][16 channels] box of x8 [b, t, h,
    w, ci_pad] at coordinates (c, w, h, t, b), innermost first; elements
    outside x8, negative coordinates included, read 0."""
    nb, nt, nh, nw, _ = x8.shape
    out = np.zeros((box_w, tci.WG_SLOT_CH), np.int64)
    if 0 <= b < nb and 0 <= t < nt and 0 <= h < nh:
        lo, hi = max(w, 0), min(w + box_w, nw)
        if lo < hi:
            out[lo - w:hi - w] = x8[b, t, h, lo:hi, c:c + tci.WG_SLOT_CH]
    return out


def emulate_wgmma(x8, wk, co, time_pad, pl):
    """The int32 sums of csrc/conv_int8.cu's ``conv3d_int8_wgmma`` for x8
    [b, t_in, h, w, ci_pad] and wk [27, co_pad, ci_pad], walked as the
    kernel walks them."""
    b, t_in, h, w, ci_pad = x8.shape
    t_out = t_in + time_pad - 2
    slots = tci.WG_CHUNK // tci.WG_SLOT_CH
    out = np.zeros((b, co, t_out, h, w), np.int64)
    for bx in range(pl.grid[0]):
        hh, seg = divmod(bx, pl.segs)
        w0 = seg * pl.bm
        for by in range(pl.grid[1]):
            n0 = by * pl.bn
            for bz in range(pl.grid[2]):
                bi, to = divmod(bz, t_out)
                acc = np.zeros((pl.bm, pl.bn), np.int64)
                for u in tci.wgmma_units(ci_pad, time_pad, to):
                    kt, kh, c0 = tci.unit_origin(ci_pad, u)
                    # the producer's A stage: per run, eight boxes of 16 channels
                    boxes = [[tma_box(x8, c0 + j * tci.WG_SLOT_CH, w0 + r * pl.run - 1,
                                      hh + kh - 1, to + kt - time_pad, bi, pl.box_w)
                              for j in range(slots)] for r in range(2)]
                    for kw in range(3):
                        bt = wk[kt * 9 + kh * 3 + kw, n0:n0 + pl.bn, c0:c0 + tci.WG_CHUNK]
                        for r in range(2):
                            for mb in range(pl.mb):
                                for kk in range(tci.WG_CHUNK // 32):
                                    # descriptor: start at pixel mb * 64 + kw of
                                    # box 2 kk, channels 16..31 one box (LBO) on
                                    rows = slice(mb * 64 + kw, mb * 64 + kw + 64)
                                    a = np.concatenate([boxes[r][2 * kk][rows],
                                                        boxes[r][2 * kk + 1][rows]], axis=1)
                                    prod = a.astype(np.float64) @ bt[:, 32 * kk:32 * kk + 32].T
                                    m0 = r * pl.run + mb * 64
                                    acc[m0:m0 + 64] += prod.astype(np.int64)
                # the epilogue's clips at w and at co
                keep, nk = min(pl.bm, w - w0), min(pl.bn, co - n0)
                out[bi, n0:n0 + nk, to, hh, w0:w0 + keep] = acc[:keep, :nk].T
    return out


@pytest.mark.parametrize("mode, w, co", [("full", 136, 256), ("init", 20, 256),
                                         ("cont", 136, 256), ("cont", 20, 3)])
def test_wgmma_walk_equals_the_plain_sums(convs, mode, w, co):
    """full: 2 frames after 2 causal zero frames (the first output frame's
    kt < 2 units skipped); init: the zero frames already in x; cont: 2
    context frames. b = 2, so a negative t must read zeros, not the other
    batch's frames; co = 3 takes the 16-channel tile."""
    convs, xs = convs
    conv = convs[co]
    x = xs[w][:, :, 2:] if mode == "full" else xs[w].clone()
    if mode == "init":
        x[:, :, :2] = 0.0
    time_pad = 2 if mode == "full" else 0
    b, ci, t_in, h, _ = x.shape
    pl = tci.plan(ci, co, h, w, b, t_in + time_pad - 2)
    assert pl.kernel == "wgmma" and pl.mb == (2 if w > 128 else 1)
    assert pl.bn == (128 if co == 256 else 16)
    x8, _ = tci.quantize_input_k3(x)
    got = emulate_wgmma(x8.numpy(), conv.weight_k3.numpy(), co, time_pad, pl)
    ref = tci.accumulate_plain(tci.quantize_input(x)[0], conv.weight_int8, time_pad)
    assert got.shape == tuple(ref.shape)
    np.testing.assert_array_equal(got, ref.numpy().astype(np.int64))


@pytest.mark.parametrize("ci, co", [(3, 3), (3, 128), (8, 8)])
def test_packed_weight_layout(ci, co):
    """Row n of the packed weight: for each tap (kt, kh, kw), kw fastest,
    the tap's ci channels and zeros up to cpk = ci rounded up to 4; zeros
    up to K_pad; zero rows for the padding channels up to co_pad."""
    rng = np.random.default_rng(3)
    w8 = torch.from_numpy(rng.integers(-127, 128, (co, ci, 3, 3, 3)).astype(np.int8))
    wp = tci.packed_weight(w8).numpy()
    cpk, k_pad = tci.packed_k(ci)
    assert cpk % 4 == 0 and k_pad % tci.PACKED_CHUNK == 0 and k_pad >= 27 * cpk
    assert wp.shape == (-(-co // tci.channel_tile(co)) * tci.channel_tile(co), k_pad)
    assert wp.dtype == np.int8
    for kt in range(3):
        for kh in range(3):
            for kw in range(3):
                k0 = (kt * 9 + kh * 3 + kw) * cpk
                np.testing.assert_array_equal(wp[:co, k0:k0 + ci], w8[:, :, kt, kh, kw].numpy())
                assert not wp[:, k0 + ci:k0 + cpk].any()
    assert not wp[:, 27 * cpk:].any() and not wp[co:].any()
    if ci == 3:
        assert (cpk, k_pad) == (4, 128)          # conv_in: one 128-byte row a pixel


def emulate_packed(x8, wp, ci, co, time_pad, pl, rng):
    """The int32 sums of csrc/conv_int8.cu's ``conv3d_int8_packed`` for x8
    [b, t_in, h, w, 32] and the packed weight [co_pad, K_pad], walked as
    the kernel walks them: each CTA of each channel slice takes the items
    ``grid[0]`` apart."""
    b, t_in, h, w, _ = x8.shape
    t_out = t_in + time_pad - 2
    cpk, k_pad = tci.packed_k(ci)
    assert wp.shape[1] == k_pad
    out = np.zeros((b, co, t_out, h, w), np.int64)
    items = tci.packed_items(pl, h, b, t_out)
    seen = set()
    for nt in range(pl.grid[1]):
        n0 = nt * pl.bn
        bt = wp[n0:n0 + pl.bn].astype(np.int64)
        for cta in range(pl.grid[0]):
            for item in range(cta, items, pl.grid[0]):
                bi, to, hh, w0 = tci.packed_item_origin(pl, h, t_out, item)
                seen.add((nt, item))
                # the producer's box: frames to - time_pad .. + 2, rows hh - 1 .. + 1
                box = [[tma_box(x8, 0, w0 - 1, hh + kh - 1, to + kt - time_pad, bi,
                                tci.PACKED_BM + 2) for kh in range(3)] for kt in range(3)]
                # the packed A: bytes past 27 * cpk are never written
                a = rng.integers(-128, 128, (tci.PACKED_BM, k_pad)).astype(np.int64)
                for kt in range(3):
                    for kh in range(3):
                        for kw in range(3):
                            k0 = (kt * 9 + kh * 3 + kw) * cpk
                            a[:, k0:k0 + cpk] = box[kt][kh][kw:kw + tci.PACKED_BM, :cpk]
                acc = a @ bt.T
                keep, nk = min(tci.PACKED_BM, w - w0), min(pl.bn, co - n0)
                out[bi, n0:n0 + nk, to, hh, w0:w0 + keep] = acc[:keep, :nk].T
    assert len(seen) == pl.grid[1] * items, "a work item was taken twice or never"
    return out


@pytest.mark.parametrize("mode", ["full", "init", "cont"])
@pytest.mark.parametrize("ci, co", [(3, 16), (8, 128)])
def test_packed_walk_equals_the_plain_sums(mode, ci, co):
    """b = 2 (a negative t must read zeros, not the other batch's frames),
    w = 70 (a second row segment mostly past w), a grid of 5 CTAs so that
    each walks several items; 8 -> 128 packs two 128-byte K rows."""
    rng = np.random.default_rng(4)
    conv = torch.nn.Conv3d(ci, co, 3).requires_grad_(False)
    conv.weight.copy_(torch.from_numpy((rng.standard_normal((co, ci, 3, 3, 3)) * 0.05)
                                       .astype(np.float32)))
    tci.quantize_conv_weights(conv)
    b, h, w, n = 2, 3, 70, 2
    x = torch.from_numpy(rng.standard_normal((b, ci, n if mode == "full" else n + 2, h, w))
                         .astype(np.float32))
    if mode == "init":
        x[:, :, :2] = 0.0
    time_pad = 2 if mode == "full" else 0
    pl = tci.plan(ci, co, h, w, b, n, sms=5)
    assert pl.kernel == "packed" and pl.grid[0] == 5
    x8, _ = tci.quantize_input_k3(x)
    assert x8.shape[-1] == tci.CI_STEP
    got = emulate_packed(x8.numpy(), conv.weight_k3_packed.numpy(), ci, co, time_pad, pl,
                         rng)
    ref = tci.accumulate_plain(tci.quantize_input(x)[0], conv.weight_int8, time_pad)
    np.testing.assert_array_equal(got, ref.numpy().astype(np.int64))


def test_quantise_rounds_ties_to_even(monkeypatch):
    """amax 127 makes sx = 1: +-0.5, +-1.5, +-2.5 and +-126.5 quantise to
    0, +-2, +-2 and +-126, as deepv_tpu's x8 (the int8 input its
    ``conv3d_int8`` hands XLA's conv), channels-last with zero padding."""
    rng = np.random.default_rng(1)
    vals = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 126.5, -126.5, 3.0, -4.0], np.float32)
    x = vals[rng.integers(0, len(vals), (1, 5, 2, 3, 8))]
    x[0, 0, 0, 0, 0] = 127.0
    captured = []
    conv = jci.lax.conv_general_dilated

    def spy(lhs, rhs, *args, **kwargs):
        captured.append(np.asarray(lhs))
        return conv(lhs, rhs, *args, **kwargs)

    monkeypatch.setattr(jci.lax, "conv_general_dilated", spy)
    jci.conv3d_int8(jnp.asarray(x), {"weight": jnp.ones((4, 5, 3, 3, 3), jnp.float32)})
    (x8_ref,) = captured
    x8, sx = tci.quantize_input_k3(torch.from_numpy(x))
    assert float(sx) == 1.0 and x8.shape == (1, 2, 3, 8, 32)
    np.testing.assert_array_equal(x8[..., :5].numpy(), x8_ref.transpose(0, 2, 3, 4, 1))
    assert not x8[..., 5:].any()
    expect = {0.5: 0, -0.5: 0, 1.5: 2, -1.5: -2, 2.5: 2, -2.5: -2, 126.5: 126, -126.5: -126}
    for v, q in expect.items():
        assert (x8_ref[x == v] == q).all() and (x == v).any(), v
