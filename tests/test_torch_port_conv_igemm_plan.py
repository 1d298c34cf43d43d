"""The host-side plan of the port's implicit-GEMM conv kernel (K2), on the CPU.

The ``wgmma`` kernel cannot run here, so what surrounds it is held in plain
Python (``deepv_tpu_torch/ops/conv_igemm.py``) and tested against the plain
version:

  * a float64 emulation that walks the kernel's order: per output frame,
    each of its K iterations (tap, 64-channel chunk) as out-of-bounds-zeroed
    ``[64 ci][64 px]`` boxes over x in its own ``[b, ci, t, h, w]`` layout
    times the ``[27, co, ci]`` weight, then the bias, the store clipped at
    h and w. It must equal ``conv3d_igemm_plain`` in float64 to atol 1e-10
    (the same products, summed in another order) at deepv_tpu's four shapes
    of tests/test_conv_igemm.py and one 80-wide shape, with every tile the
    kernel has;
  * a float32 emulation of the ``cl`` path's walk (x channels-last, as
    the encoder's mid block hands it on, or copied channels-last because w
    % 8 != 0): per output frame its (kt, kh, 64-channel chunk) units in
    kernel order with the causal-past units skipped, each run's box of
    ``[66 px][64 ci]`` read under TMA's zero fill and started
    kw rows in for the three taps, times the ``[27, co, ci]`` weight. It must equal
    ``conv3d_igemm_plain`` to atol 1e-5 in ``full``, ``init`` and ``cont``;
  * the plan covers every output element exactly once and every K index
    once per output tile, at all 14 conv classes of the full-width rollout
    and at the edge shapes; the ``cl`` path's tile at its rollout call and
    at the edge shapes;
  * the choice of kernel by dtype, width and strides.
"""

import numpy as np
import pytest
import torch

from deepv_tpu_torch.ops import conv_igemm as cig

torch.set_num_threads(1)

#: (b, ci, co, t_in, h, w, time_pad): tests/test_conv_igemm.py's shapes, and
#: an 80-wide frame whose second run is mostly past w
EMULATED = [
    (1, 128, 128, 2, 8, 8, 2),
    (2, 128, 256, 1, 4, 8, 2),
    (1, 256, 128, 3, 8, 16, 2),
    (1, 128, 128, 4, 8, 8, 0),
    (1, 128, 128, 4, 4, 80, 0),
]
#: every eligible conv class of the full-width rollout (ci, co, h, w)
ROLLOUT_CLASSES = [
    (128, 128, 384, 512), (256, 512, 384, 512), (256, 128, 384, 512),
    (256, 256, 192, 256), (512, 1024, 192, 256), (256, 1024, 192, 256),
    (512, 256, 192, 256), (128, 256, 192, 256), (512, 512, 96, 128),
    (512, 2048, 96, 128), (512, 1024, 96, 128), (256, 512, 96, 128),
    (512, 512, 48, 64), (512, 2048, 48, 64),
]
#: chip_smoke.py's edge cases (ci, co, h, w, b, t_out, time_pad) of the wgmma kernel
EDGE_CASES = [(128, 128, 48, 80, 1, 2, 0), (256, 256, 96, 128, 2, 3, 2)]


#: SMs of the H100
SMS = 132


def tiles(co):
    return [bn for bn in cig.TILES if co % bn == 0]


def box(xb, c0, t, rows, cols):
    """``[M, R, 64 ci, 64 px]``: the TMA boxes of x[b] at channels c0..c0+63,
    frame t, each run's row and first column; zero outside x."""
    _, t_in, h, w = xb.shape
    wcols = cols[..., None] + torch.arange(cig.RUN)
    hrows = rows[..., None].expand_as(wcols)
    valid = (hrows >= 0) & (hrows < h) & (wcols >= 0) & (wcols < w) & (0 <= t < t_in)
    vals = xb[c0:c0 + cig.BK, min(max(t, 0), t_in - 1)][:, hrows.clamp(0, h - 1),
                                                          wcols.clamp(0, w - 1)]
    return (vals * valid).permute(1, 2, 0, 3)


def emulate_wgmma(x, weight, bias, time_pad, plan):
    """The wgmma kernel's arithmetic in its order, all N tiles at once."""
    co, ci = weight.shape[:2]
    b, _, t_in, h, w = x.shape
    t_out = t_in + time_pad - 2
    wk = cig.relayout_weight(weight, x.dtype)
    runs = [cig.tile_runs(plan, m) for m in range(plan.m_tiles)]
    rows = torch.tensor([[r[0] for r in rr] for rr in runs])
    cols = torch.tensor([[r[1] for r in rr] for rr in runs])
    m, bm = plan.m_tiles, cig.RUNS * cig.RUN
    y = torch.full((b, co, t_out, h, w), float("nan"), dtype=x.dtype)
    for bi in range(b):
        for to in range(t_out):
            total = torch.zeros((m, bm, co), dtype=x.dtype)
            for it in cig.k_iterations(ci, time_pad, to):
                kt, kh, kw, c0 = cig.iteration_tap(ci, it)
                a = box(x[bi], c0, to + kt - time_pad, rows + kh - 1, cols + kw - 1)
                a = a.permute(0, 2, 1, 3).reshape(m, cig.BK, bm)            # [M, 64 ci, BM]
                total += a.transpose(1, 2) @ wk[kt * 9 + kh * 3 + kw, :, c0:c0 + cig.BK].T
            total = total + bias
            for mi, rr in enumerate(runs):
                for r, (hh, w0) in enumerate(rr):
                    n = min(cig.RUN, w - w0)
                    if hh < h and n > 0:
                        y[bi, :, to, hh, w0:w0 + n] = total[mi, r * cig.RUN:r * cig.RUN + n].T
    return y


@pytest.mark.parametrize("shape,bn", [
    (shape, bn) for shape in EMULATED for bn in tiles(shape[2])
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_emulated_kernel_order_matches_plain(shape, bn):
    b, ci, co, t_in, h, w, time_pad = shape
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((b, ci, t_in, h, w)))
    weight = torch.from_numpy(0.02 * rng.standard_normal((co, ci, 3, 3, 3)))
    bias = torch.from_numpy(0.1 * rng.standard_normal(co))
    plan = cig.make_plan(bn, co, b * (t_in + time_pad - 2), h, w)
    got = emulate_wgmma(x, weight, bias, time_pad, plan)
    p = type("P", (), {"weight": weight, "bias": bias})
    want = cig.conv3d_igemm_plain(x, p, time_pad)
    assert not torch.isnan(got).any(), "an output element was never stored"
    torch.testing.assert_close(got, want, atol=1e-10, rtol=0)


def cl_box(x, bi, c0, t, hh, w0):
    """``[66 px][64 ci]``: the channels-last path's A load for one run, the
    pixels w0 - 1 .. w0 + 64 of row hh of frame t, channels c0..c0+63, with
    TMA's zero fill outside x (a negative t never reads another batch)."""
    _, _, t_in, h, w = x.shape
    out = torch.zeros((cig.RUN + 2, cig.BK), dtype=x.dtype)
    if 0 <= t < t_in and 0 <= hh < h:
        lo, hi = max(w0 - 1, 0), min(w0 + cig.RUN + 1, w)
        if lo < hi:
            out[lo - w0 + 1:hi - w0 + 1] = x[bi, c0:c0 + cig.BK, t, hh, lo:hi].T
    return out


def emulate_cl(x, weight, bias, time_pad, plan):
    """The ``cl`` path's arithmetic in its order: per CTA (M tile, N tile,
    frame) the units of ``k_iterations`` (causal past skipped), one box per
    unit and run serving kw = 0, 1, 2 as rows kw .. kw + 63."""
    co, ci = weight.shape[:2]
    b, _, t_in, h, w = x.shape
    t_out = t_in + time_pad - 2
    wk = cig.relayout_weight(weight, x.dtype)
    y = torch.full((b, co, t_out, h, w), float("nan"), dtype=x.dtype)
    for m in range(plan.m_tiles):
        for n0 in range(0, co, plan.bn):
            for bi in range(b):
                for to in range(t_out):
                    its = list(cig.k_iterations(ci, time_pad, to))
                    for r, (hh, w0) in enumerate(cig.tile_runs(plan, m)):
                        acc = torch.zeros((cig.RUN, plan.bn), dtype=x.dtype)
                        for it in its[::3]:
                            kt, kh, kw0, c0 = cig.iteration_tap(ci, it)
                            assert kw0 == 0
                            a = cl_box(x, bi, c0, to + kt - time_pad, hh + kh - 1, w0)
                            for kw in range(3):
                                bt = wk[kt * 9 + kh * 3 + kw, n0:n0 + plan.bn, c0:c0 + cig.BK]
                                acc += a[kw:kw + cig.RUN] @ bt.T
                        acc += bias[n0:n0 + plan.bn]
                        n = min(cig.RUN, w - w0)
                        if hh < h and n > 0:
                            y[bi, n0:n0 + plan.bn, to, hh, w0:w0 + n] = acc[:n].T
    return y


@pytest.mark.parametrize("mode", ["full", "init", "cont"])
@pytest.mark.parametrize("layout", ["channels_last", "w_not_8"])
def test_emulated_cl_order_matches_plain(mode, layout):
    """b = 2 (a negative t must read zeros, not the other batch's frames);
    ci = 128 (two chunks); channels-last x at w = 8, or a contiguous x at
    w = 10, which the wrapper copies channels-last."""
    rng = np.random.default_rng(2)
    b, ci, co, h, n = 2, 128, 128, 4, 2
    w = 8 if layout == "channels_last" else 10
    t_in = n if mode == "full" else n + 2
    x = torch.from_numpy(rng.standard_normal((b, ci, t_in, h, w)).astype(np.float32))
    if mode == "init":
        x[:, :, :2] = 0.0
    if layout == "channels_last":
        x = x.to(memory_format=torch.channels_last_3d)
        assert cig._tma_strides_cl(x) is not None and cig._tma_strides(x) is None
    time_pad = 2 if mode == "full" else 0
    weight = torch.from_numpy((0.02 * rng.standard_normal((co, ci, 3, 3, 3))).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(co)).astype(np.float32))
    assert cig.kernel_for(x.to(torch.bfloat16)) == "cl"
    plan = cig.tile_plan(b, co, n, h, w, SMS, channels_last=True)
    assert plan.channels_last and plan.bn == cig.CL_BN
    got = emulate_cl(x, weight, bias, time_pad, plan)
    want = cig.conv3d_igemm_plain(x, type("P", (), {"weight": weight, "bias": bias}), time_pad)
    assert not torch.isnan(got).any(), "an output element was never stored"
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def check_coverage(plan, b, ci, co, t_out, h, w, time_pad):
    """Every output element stored once; every K index once per output
    tile, the skipped ones all in the causal past."""
    assert plan.grid[1] * plan.bn == co and plan.grid[2] == b * t_out
    assert plan.grid[1] <= 65535 and plan.grid[2] <= 65535
    cover = np.zeros((h, w), dtype=np.int64)
    for m in range(plan.m_tiles):
        for hh, w0 in cig.tile_runs(plan, m):
            if hh < h:
                cover[hh, w0:min(w0 + cig.RUN, w)] += 1
    assert (cover == 1).all(), f"pixels stored {cover.min()}..{cover.max()} times"
    chunks = ci // cig.BK
    for to in range(t_out):
        its = list(cig.k_iterations(ci, time_pad, to))
        assert its == sorted(set(its)), "a K index is read twice"
        skipped = sorted(set(range(27 * chunks)) - set(its))
        assert its == list(range(len(skipped), 27 * chunks))
        for it in skipped:
            kt, _, _, _ = cig.iteration_tap(ci, it)
            assert to + kt - time_pad < 0, f"iteration {it} skipped at frame {to}"


@pytest.mark.parametrize("cls", ROLLOUT_CLASSES, ids=lambda c: f"{c[0]}to{c[1]}_{c[2]}x{c[3]}")
def test_plan_covers_rollout_class(cls):
    ci, co, h, w = cls
    for b, t_out, time_pad in ((1, 1, 0), (1, 2, 0), (1, 2, 2), (1, 17, 2)):
        check_coverage(cig.tile_plan(b, co, t_out, h, w, SMS), b, ci, co, t_out, h, w, time_pad)
    for bn in tiles(co):
        check_coverage(cig.make_plan(bn, co, 2, h, w), 1, ci, co, 2, h, w, 0)


@pytest.mark.parametrize("case", EDGE_CASES, ids=lambda c: "x".join(map(str, c)))
def test_plan_covers_edge_shape(case):
    ci, co, h, w, b, t_out, time_pad = case
    assert cig.kernel_for(torch.empty((b, ci, 1, h, w), dtype=torch.bfloat16)) == "wgmma"
    for bn in tiles(co):
        check_coverage(cig.make_plan(bn, co, b * t_out, h, w), b, ci, co, t_out, h, w, time_pad)
    check_coverage(cig.tile_plan(b, co, t_out, h, w, SMS), b, ci, co, t_out, h, w, time_pad)


@pytest.mark.parametrize("dtype,w,kernel", [
    ("bfloat16", 512, "wgmma"), ("bfloat16", 64, "wgmma"), ("bfloat16", 80, "wgmma"),
    ("bfloat16", 8, "wgmma"), ("bfloat16", 10, "cl"), ("bfloat16", 6, "cl"),
    ("float32", 512, "tf32x3"), ("float32", 10, "tf32x3"),
])
def test_kernel_choice_by_dtype_and_width(dtype, w, kernel):
    assert cig.supports_igemm((128, 128, 3, 3, 3), (1, 1, 1), getattr(torch, dtype), 4, w)
    assert cig.kernel_for(torch.empty((1, 128, 2, 4, w), dtype=getattr(torch, dtype))) == kernel


def test_kernel_choice_of_views_tma_cannot_read():
    """A bf16 view whose strides or start TMA cannot describe along w takes
    the ``cl`` path (through a channels-last copy where the view is not
    channels-last either); a frame slice of a contiguous x stays on wgmma,
    and a channels-last x is read as it is."""
    x = torch.zeros((1, 128, 5, 8, 16), dtype=torch.bfloat16)
    assert cig.kernel_for(x[:, :, 1:3]) == "wgmma"
    assert cig.kernel_for(x[..., 2:10]) == "cl"
    assert cig.kernel_for(x.transpose(3, 4)[..., :8, :]) == "cl"
    xcl = x.to(memory_format=torch.channels_last_3d)
    assert cig.kernel_for(xcl) == "cl"
    assert cig._tma_strides_cl(xcl) == (5 * 8 * 16 * 128, 8 * 16 * 128, 16 * 128, 128)
    assert cig._tma_strides_cl(x[..., 2:10]) is None


@pytest.mark.parametrize("sms,bn", [(132, 128), (48, 256)])
def test_small_calls_fill_the_card(sms, bn):
    """512->512 @48x64, one frame: 48 tiles of 128x256. On the H100's 132
    SMs they would leave 84 idle, so the plan takes the 128-wide tile (96
    CTAs, one round). On a card of 48 SMs the 96 narrow tiles would take two
    rounds, and the wide tile wins."""
    assert cig.tile_plan(1, 512, 1, 48, 64, sms).bn == bn


@pytest.mark.parametrize("case", [
    ((1, 512, 1, 48, 64), 96),      # the encoder's mid-block resnet: the rollout's one cl call
    ((1, 128, 1, 6, 10), 3),        # chip_smoke.py's w % 8 != 0 edge
    ((1, 256, 2, 96, 128), 384),    # a large call: every SM takes several tiles
], ids=["onpath_512x48x64", "edge_6x10", "large_96x128"])
def test_cl_plan_by_the_busiest_sm(case):
    """The cl path's one tile, 128 x 128, one CTA an SM. At the rollout's
    call its 96 CTAs leave 36 of 132 SMs idle; a 64-wide tile, two CTAs an
    SM, filled them (192 CTAs) but ran slower there, since each of its CTAs
    re-reads the run's A for half the products (PERF.md), and was dropped."""
    (b, co, t_out, h, w), ctas = case
    plan = cig.tile_plan(b, co, t_out, h, w, SMS, channels_last=True)
    assert (plan.bn, plan.channels_last, plan.ctas) == (128, True, ctas), plan
    assert plan == cig.make_plan(128, co, b * t_out, h, w, channels_last=True)
    check_coverage(plan, b, 512, co, t_out, h, w, 2)


def test_relayout_weight_is_k_major():
    rng = np.random.default_rng(1)
    weight = torch.from_numpy(rng.standard_normal((256, 128, 3, 3, 3)).astype(np.float32))
    wk = cig.relayout_weight(weight, torch.bfloat16)
    assert wk.shape == (27, 256, 128) and wk.is_contiguous() and wk.dtype == torch.bfloat16
    for kt, kh, kw in ((0, 0, 0), (1, 2, 0), (2, 1, 2)):
        torch.testing.assert_close(wk[kt * 9 + kh * 3 + kw],
                                   weight[:, :, kt, kh, kw].to(torch.bfloat16), atol=0, rtol=0)


def test_k_major_weight_follows_writes_through_data():
    """The wrapper re-lays the weight out on every call and keeps nothing on
    the parameter, so a write through ``.data`` (which leaves the
    parameter's version counter as it was) is seen by the next call."""
    weight = torch.nn.Parameter(torch.randn((128, 128, 3, 3, 3)), requires_grad=False)
    version = weight._version
    cig.relayout_weight(weight, torch.bfloat16)
    weight.data.copy_(torch.ones_like(weight))
    assert weight._version == version
    assert (cig.relayout_weight(weight, torch.bfloat16) == 1).all()
    assert [k for k in vars(weight) if "igemm" in k] == []


def test_tma_strides_of_views():
    x = torch.zeros((2, 128, 5, 8, 16), dtype=torch.bfloat16)
    assert cig._tma_strides(x) == (128 * 5 * 128, 5 * 128, 128, 16)
    # a frame slice keeps x's strides; a one-frame slice gets the dense one
    assert cig._tma_strides(x[:, :, 1:3]) == (128 * 5 * 128, 5 * 128, 128, 16)
    assert cig._tma_strides(x[:, :, 2:3]) == (128 * 5 * 128, 5 * 128, 128, 16)
    # a column slice starts 2 bytes into a row: TMA cannot take it
    assert cig._tma_strides(x[..., 1:9]) is None
    assert cig._tma_strides(x.transpose(3, 4)) is None


def test_weight_planes_are_the_split_relayout():
    """The f32 kernel's weight planes: ``split_tf32_cl`` reads the weight
    ``[co, ci, 3, 3, 3]`` as one frame of co * ci channels over 27 pixels,
    which in its channels-last output is ``relayout_weight``'s ``[27, co,
    ci]``; so its plain version there equals the TF32 split of that
    layout, and x's planes are the split of x channels-last."""
    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.standard_normal((256, 128, 3, 3, 3)).astype(np.float32))
    planes = cig.split_tf32_cl_plain(w.reshape(1, 256 * 128, 3, 3, 3)).reshape(2, 27, 256, 128)
    assert torch.equal(planes, torch.stack(cig.tf32_split(cig.relayout_weight(w, torch.float32))))
    x = torch.from_numpy(rng.standard_normal((2, 128, 3, 4, 6)).astype(np.float32))
    xp = cig.split_tf32_cl_plain(x[:, :, 1:])
    assert tuple(xp.shape) == (2, 2, 2, 4, 6, 128)
    big, small = cig.tf32_split(x[:, :, 1:].permute(0, 2, 3, 4, 1))
    assert torch.equal(xp[0], big) and torch.equal(xp[1], small)
