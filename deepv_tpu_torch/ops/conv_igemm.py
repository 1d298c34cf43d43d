"""Implicit-GEMM causal conv: the hand-written Hopper kernels and their plain version.

Counterpart of ``deepv_tpu/ops/conv_igemm.py``. A 3x3x3 stride-1 conv with a
torch-layout weight ``[co, ci, 3, 3, 3]``:

    y[b, co, t, h, w] = bias[co]
        + sum_{kt, kh, kw, ci} w[co, ci, kt, kh, kw] * x_pad[b, ci, t + kt, h + kh - 1, w + kw - 1]

``time_pad=2`` puts two zero frames in the temporal past (``full`` mode);
``time_pad=0`` expects the kt-1 context frames already concatenated by the
caller (``init``/``cont``/``prime``). Spatial borders are zero. Products
accumulate in float32; the bias, cast to x's dtype, is added in float32
after the sum, and the result is rounded once to x's dtype. Those are the
TPU kernel's rounding points (``conv_igemm.py:77-85``, ``:115-116``).

Kernels (``csrc/conv_igemm.cu``), replacing
``deepv_tpu/ops/conv_igemm.py::_kernel``; at the VAE's eligible layers the
call does 1e3-1e4 operations per byte moved, far above the H100's bf16
ridge point, so the products bound it. ``kernel_for`` picks one by dtype,
width and strides:

  * ``wgmma`` (bf16, w % 8 == 0, every conv of the rollout but one): TMA
    loads ``[64 ci][88 pixel]`` halo boxes straight from x in its own ``[b,
    ci, t, h, w]`` layout, one per (kt, kh, 64-channel chunk) and 64-pixel
    run (TMA's zero fill supplies the causal and spatial halo), and ``[co,
    64 ci]`` boxes of the weight, re-laid out to ``[27, co, ci]`` on every
    call (``relayout_weight``). Two consumer warpgroups read the three
    kw-shifted A operands of each box into registers and run ``wgmma`` on
    them; one producer thread keeps both rings full. No copy of x.
  * ``cl`` (bf16 that the ``wgmma`` path's map cannot read along w: x
    channels-last, as the encoder's mid block hands it on after its
    attention, or w % 8 != 0, or a view whose strides or start are not
    16-byte multiples): the same kernel template with its A operand read
    K-major from shared memory: per unit and run one 128-byte-swizzled TMA
    box of ``[66 px][64 ci]`` over x channels-last (the view itself, else
    one channels-last copy), read for tap kw from row kw on. It replaces
    an earlier ``cp.async`` gather kernel, which ran WMMA on sm_80 fragments,
    walked the causal past and re-laid the weight out a second way; this
    path shares the ``wgmma`` path's weight, K walk (causal-past units
    skipped), 128-wide tile and epilogue.
  * ``tf32x3`` (float32): the ``cl`` path's structure on the TF32 tensor
    cores by 3xTF32, about f32 accuracy (``csrc/tf32x3.cuh``). One pass of
    ``split_tf32_cl`` (a small kernel of the same source) writes x as two
    channels-last planes, big = tf32(x) and small = tf32(x - big), and the
    weight as two planes of the ``[27, co, ci]`` layout; the conv kernel
    reads per unit and run one swizzled TMA box of ``[66 px][32 ci]`` per
    plane (32 f32 channels are one 128-byte row) and issues three
    ``wgmma.m64n128k8`` TF32 products per k8 slice (small.big, big.small,
    big.big), skipping units in the causal past; 128 x 128 tiles.
    ``conv3d_igemm_3xtf32`` is its arithmetic in plain PyTorch.

``tile_plan`` picks the ``wgmma`` path's tile so that calls with few tiles
fill the card; the ``cl`` path has one tile, 128 x 128. A 64-wide ``cl``
tile, two CTAs an SM, filled the card at the encoder's call but ran slower
there (each CTA re-reads the run's A for half the products; PERF.md).
``conv3d_igemm`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches a kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .basic import compute_dtype, tf32_split

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the ``wgmma`` kernel since the count was last set to 0
launches = 0
#: launches of the ``cl`` path and of the f32 ``tf32x3`` conv kernel, counted
#: apart, and of ``split_tf32_cl`` (two a ``tf32x3`` call: x, the weight)
cl_launches = 0
f32_launches = 0
split_launches = 0

_library: Optional[ctypes.CDLL] = None

#: pixels of a run (one TMA row segment of x), runs of an M tile (one per
#: consumer warpgroup) and input channels per K step
RUN = 64
RUNS = 2
BK = 64
#: the wgmma kernel's tile widths (output channels) and their rates relative
#: to each other, fitted to tools/conv_igemm_plans.py on the H100: where
#: both fill the card, the 128-wide tile ran 3-9% slower than the 256-wide one
TILES = {256: 1.0, 128: 0.94}
#: the ``cl`` and ``tf32x3`` paths' tile width
CL_BN = 128


def supports_igemm(weight_shape: Tuple[int, ...], stride: Tuple[int, int, int],
                   dtype: torch.dtype, h: int, w: int) -> bool:
    """Dispatch predicate (deepv_tpu's rule): 3x3x3 stride-1 convs in bf16
    or f32 with ci and co multiples of 128 and even h and w."""
    co, ci = weight_shape[:2]
    return (tuple(weight_shape[2:]) == (3, 3, 3)
            and tuple(stride) == (1, 1, 1)
            and dtype in (torch.bfloat16, torch.float32)
            and ci % 128 == 0 and co % 128 == 0
            and h % 2 == 0 and w % 2 == 0)


def kernel_for(x: torch.Tensor) -> str:
    """The kernel a supported call on x runs: ``wgmma`` for bf16 when TMA
    can read x along w (w % 8 == 0 and ``_tma_strides``), ``cl`` for the
    other bf16 inputs, ``tf32x3`` for float32."""
    if x.dtype == torch.float32:
        return "tf32x3"
    return "wgmma" if x.shape[-1] % 8 == 0 and _tma_strides(x) is not None else "cl"


@dataclass(frozen=True)
class TilePlan:
    """How the ``wgmma`` kernel template covers one call. An M tile is
    ``RUNS`` runs of 64 pixels; run ``r`` of a frame is row ``r //
    runs_per_row``, columns from ``(r % runs_per_row) * 64``. The grid is
    ``(m_tiles, co // bn, b * t_out)``. ``channels_last``: A is read
    from x channels-last (the ``cl`` path), else from x ``[b, c, t, h, w]``
    (the ``wgmma`` path)."""

    bn: int
    runs_per_row: int
    m_tiles: int
    co: int
    frames: int
    channels_last: bool = False

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (self.m_tiles, self.co // self.bn, self.frames)

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def make_plan(bn: int, co: int, frames: int, h: int, w: int,
              channels_last: bool = False) -> TilePlan:
    """The plan of one tile width and A source (the kernel's own
    arithmetic: csrc/conv_igemm.cu, ``deepv_conv3d_igemm_wgmma``)."""
    runs_per_row = -(-w // RUN)
    return TilePlan(bn, runs_per_row, -(-h * runs_per_row // RUNS), co, frames, channels_last)


def tile_plan(b: int, co: int, t_out: int, h: int, w: int, sms: int,
              channels_last: bool = False) -> TilePlan:
    """The tile of the ``wgmma`` path (or, ``channels_last``, the one tile
    of the ``cl`` and ``tf32x3`` paths) for one call on a card with ``sms``
    SMs. The busiest SM takes ``ceil(CTAs / sms)`` tiles (one CTA holds an
    SM), each costing its width over its rate. The cheapest plan wins; a
    tie goes to the wider tile."""
    if channels_last:
        return make_plan(CL_BN, co, b * t_out, h, w, True)
    best, best_cost = None, math.inf
    for bn, rate in TILES.items():
        if co % bn:
            continue
        plan = make_plan(bn, co, b * t_out, h, w)
        cost = -(-plan.ctas // sms) * bn / rate
        if cost < best_cost:
            best, best_cost = plan, cost
    return best


def tile_runs(plan: TilePlan, m_tile: int):
    """(row, first column) of each run of M tile ``m_tile``; rows past h
    load zeros and are not stored, as are columns past w."""
    out = []
    for r in range(RUNS):
        run = m_tile * RUNS + r
        out.append((run // plan.runs_per_row, (run % plan.runs_per_row) * RUN))
    return out


def k_iterations(ci: int, time_pad: int, to: int) -> range:
    """K iterations for output frame ``to``. The K loop walks units (kt, kh,
    64-channel chunk), kt-major, each one TMA box per run that serves the
    three kw taps: iteration ``it`` is unit ``it // 3``, tap column ``kw =
    it % 3`` (``iteration_tap``). Units whose input frame lies in the
    causal past (kt < time_pad - to) are skipped."""
    chunks = ci // BK
    return range(3 * max(0, time_pad - to) * 3 * chunks, 27 * chunks)


def iteration_tap(ci: int, it: int) -> Tuple[int, int, int, int]:
    """(kt, kh, kw, first channel) of K iteration ``it``."""
    chunks = ci // BK
    unit, kw = divmod(it, 3)
    g, c = divmod(unit, chunks)
    return g // 3, g % 3, kw, c * BK


def relayout_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``[co, ci, kt, kh, kw]`` -> the ``wgmma`` kernel's K-major ``[27, co,
    ci]`` (tap-major, ci contiguous) in ``dtype``."""
    co, ci = weight.shape[:2]
    return weight.to(dtype).permute(2, 3, 4, 0, 1).reshape(27, co, ci).contiguous()


def _bias(p, co: int, like: torch.Tensor) -> torch.Tensor:
    bias = getattr(p, "bias", None)
    return like.new_zeros((co,)) if bias is None else bias.to(like.dtype)


def conv3d_igemm_plain(x: torch.Tensor, p, time_pad: int = 2) -> torch.Tensor:
    """Plain PyTorch version with the kernel's arithmetic: a channels-last
    halo-padded input, weights cast to x's dtype, at-least-f32 accumulation
    of the 27 taps' products, the bias (in x's dtype) added in that type,
    one rounding. It loops over output frames, so no tap stack of a whole
    clip is ever built. x [b, ci, t, h, w] -> [b, co, t + time_pad - 2, h, w]."""
    co, ci = p.weight.shape[:2]
    b, _, t_in, h, w = x.shape
    t_out = t_in + time_pad - 2
    if t_out < 1:
        raise ValueError(f"igemm conv needs t_in + time_pad - 2 >= 1, got t_in={t_in}, "
                         f"time_pad={time_pad}")
    acc_t = compute_dtype(x.dtype)
    # [b, t, h+2, w+2, ci] and [kt, kh, kw, ci, co], both laid out as indexed
    xp = F.pad(x, (1, 1, 1, 1, time_pad, 0)).permute(0, 2, 3, 4, 1).contiguous()
    wr = p.weight.to(x.dtype).permute(2, 3, 4, 1, 0).to(acc_t).contiguous()
    bias = _bias(p, co, x).to(acc_t)
    out = x.new_empty((b, co, t_out, h, w))
    for t in range(t_out):
        acc = torch.zeros((b, h, w, co), dtype=acc_t, device=x.device)
        for kt in range(3):
            for kh in range(3):
                for kw in range(3):
                    tap = xp[:, t + kt, kh:kh + h, kw:kw + w, :].to(acc_t)
                    acc += torch.matmul(tap, wr[kt, kh, kw])
        acc += bias
        out[:, :, t] = acc.to(x.dtype).permute(0, 3, 1, 2)
    return out


def split_tf32_cl_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``split_tf32_cl``: x ``[n, c, t, h, w]`` as two
    channels-last float32 planes ``[2, n, t, h, w, c]``, big = tf32(x) and
    small = tf32(x - big) (``basic.tf32_split``)."""
    return torch.stack(tf32_split(x.to(torch.float32).permute(0, 2, 3, 4, 1)))


def conv3d_tf32x3_products(xp: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The valid 3x3x3 conv of a padded float32 input as the ``tf32x3``
    kernel takes it: three TF32 products of the split operands, small.big +
    big.small + big.big, each a ``F.conv3d`` of TF32 values (every product
    exact in f32) summed in f32."""
    xb, xs = tf32_split(xp)
    wb, ws = tf32_split(weight)
    return F.conv3d(xs, wb) + F.conv3d(xb, ws) + F.conv3d(xb, wb)


def conv3d_igemm_3xtf32(x: torch.Tensor, p, time_pad: int = 2) -> torch.Tensor:
    """The ``tf32x3`` kernel's arithmetic in plain PyTorch (float32; for
    tests): the halo-padded input and the weight split into TF32 planes,
    three conv products summed in f32 (``conv3d_tf32x3_products``), the
    bias added after the sum. x [b, ci, t, h, w] -> [b, co, t + time_pad -
    2, h, w]."""
    co = p.weight.shape[0]
    xp = F.pad(x.to(torch.float32), (1, 1, 1, 1, time_pad, 0))
    y = conv3d_tf32x3_products(xp, p.weight.to(torch.float32))
    return y + _bias(p, co, xp)[:, None, None, None]


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _library
    if _library is None:
        from ..utils.cuda_build import build
        lib = build("conv_igemm.cu").lib
        fn = lib.deepv_conv3d_igemm_tf32x3
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.deepv_split_tf32_cl
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.deepv_conv3d_igemm_wgmma
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_int64] * 4
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _library = lib
    return _library


def _check_kernel_inputs(x: torch.Tensor, weight: torch.Tensor, bias, time_pad: int) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"igemm conv kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"x must be [b, ci, t, h, w], got {tuple(x.shape)}")
    co, ci = weight.shape[:2]
    b, xc, t_in, h, w = x.shape
    if tuple(weight.shape[2:]) != (3, 3, 3) or xc != ci:
        raise ValueError(f"weight must be [co, {xc}, 3, 3, 3], got {tuple(weight.shape)}")
    if ci % 128 or co % 128 or h % 2 or w % 2:
        raise ValueError(f"igemm conv kernel needs ci, co multiples of 128 and even h, w; "
                         f"got ci={ci} co={co} h={h} w={w}")
    if time_pad not in (0, 2) or t_in + time_pad - 2 < 1:
        raise ValueError(f"time_pad must be 0 or 2 with at least one output frame; got "
                         f"time_pad={time_pad}, t_in={t_in}")
    if bias is not None and tuple(bias.shape) != (co,):
        raise ValueError(f"bias must be [{co}], got {tuple(bias.shape)}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} must lie on x's CUDA device, got {t.device}")


def _dense_strides(sizes, order) -> list:
    """Element strides of a dense tensor of ``sizes`` whose dimensions are
    laid out in ``order``, innermost first."""
    dense, acc = [0] * len(sizes), 1
    for d in order:
        dense[d] = acc
        acc *= sizes[d]
    return dense


def _tma_strides(x: torch.Tensor) -> Optional[Tuple[int, int, int, int]]:
    """x's (b, c, t, h) element strides as a TMA tensor map takes them, or
    None when the view cannot be described (w not unit-stride, a stride or
    the address not a 16-byte multiple). A size-1 dimension is never
    stepped, so it gets the stride a contiguous tensor would have."""
    sizes, strides = x.shape, x.stride()
    dense = _dense_strides(sizes, (4, 3, 2, 1, 0))
    out = tuple(strides[d] if sizes[d] > 1 else dense[d] for d in range(4))
    if strides[4] != 1 and sizes[4] > 1:
        return None
    if any(s % 8 for s in out) or x.data_ptr() % 16:
        return None
    return out


def _tma_strides_cl(x: torch.Tensor) -> Optional[Tuple[int, int, int, int]]:
    """x's (b, t, h, w) element strides as the ``cl`` path's tensor map
    takes them (ci innermost), or None when x is not channels-last or a
    stride or the address is not a 16-byte multiple. A size-1 dimension
    gets the stride a dense channels-last tensor would have."""
    sizes, strides = x.shape, x.stride()
    dense = _dense_strides(sizes, (1, 4, 3, 2, 0))
    out = tuple(strides[d] if sizes[d] > 1 else dense[d] for d in (0, 2, 3, 4))
    if strides[1] != 1 and sizes[1] > 1:
        return None
    if any(s % 8 for s in out) or x.data_ptr() % 16:
        return None
    return out


def split_tf32_cl(x: torch.Tensor) -> torch.Tensor:
    """The ``split_tf32_cl`` kernel on a float32 CUDA tensor ``[n, c, t, h,
    w]`` of any strides: its two channels-last TF32 planes ``[2, n, t, h, w,
    c]`` (big, small), as ``split_tf32_cl_plain`` computes them."""
    global split_launches
    if x.dtype != torch.float32 or x.dim() != 5 or x.device.type != "cuda":
        raise ValueError(f"split_tf32_cl takes a float32 [n, c, t, h, w] on CUDA, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    lib = load_library()
    out = torch.empty((2, *x.shape[:1], *x.shape[2:], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    err = lib.deepv_split_tf32_cl(x.data_ptr(), out.data_ptr(), *x.shape, *x.stride(),
                                  torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"split_tf32_cl launch failed: error {err}")
    split_launches += 1
    return out


def weight_planes(weight: torch.Tensor) -> torch.Tensor:
    """The ``tf32x3`` kernel's weight: ``[co, ci, 3, 3, 3]`` as two TF32
    planes of ``relayout_weight``'s ``[27, co, ci]`` layout, ``[2, 27, co,
    ci]``, by ``split_tf32_cl`` (the weight read as one frame of co * ci
    channels over 27 pixels)."""
    co, ci = weight.shape[:2]
    w = weight.to(torch.float32).contiguous().reshape(1, co * ci, 3, 3, 3)
    return split_tf32_cl(w).reshape(2, 27, co, ci)


def conv3d_igemm(x: torch.Tensor, p, time_pad: int = 2) -> torch.Tensor:
    """3x3x3 stride-1 causal conv; ``p`` holds ``weight`` [co, ci, 3, 3, 3]
    and an optional ``bias``. x [b, ci, t, h, w] -> [b, co, t + time_pad - 2,
    h, w] in x's dtype."""
    if x.device.type == "cpu":
        return conv3d_igemm_plain(x, p, time_pad)
    _check_kernel_inputs(x, p.weight, getattr(p, "bias", None), time_pad)
    co = p.weight.shape[0]
    b, _, t_in, h, w = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = tile_plan(b, co, t_in + time_pad - 2, h, w, sms,
                     channels_last=kernel_for(x) != "wgmma")
    return launch(x, p, time_pad, plan)


def launch(x: torch.Tensor, p, time_pad: int, plan: TilePlan) -> torch.Tensor:
    """Launch the kernel ``kernel_for(x)`` names with ``plan``: for float32
    ``split_tf32_cl`` on x and the weight, then the ``tf32x3`` kernel (the
    128-wide channels-last plan); for bf16 the ``wgmma`` kernel template
    (``plan.channels_last`` says which path). ``conv3d_igemm`` checks the
    inputs."""
    global launches, cl_launches
    co, ci = p.weight.shape[:2]
    b, _, t_in, h, w = x.shape
    bv = _bias(p, co, x).contiguous()
    if x.dtype == torch.float32:
        if not plan.channels_last or plan.bn != CL_BN:
            raise ValueError(f"the tf32x3 kernel takes the {CL_BN}-wide channels-last plan")
        return conv3d_tf32x3_planes(split_tf32_cl(x), weight_planes(p.weight), bv, time_pad)
    if not plan.channels_last:
        strides = _tma_strides(x)
    else:
        if _tma_strides_cl(x) is None:                # one channels-last copy
            x = x.permute(0, 2, 3, 4, 1).contiguous().permute(0, 4, 1, 2, 3)
        strides = _tma_strides_cl(x)
    if strides is None:
        raise ValueError(f"the wgmma kernel cannot read x with strides {x.stride()}")
    wk = relayout_weight(p.weight, x.dtype)
    t_out = t_in + time_pad - 2
    out = torch.empty((b, co, t_out, h, w), dtype=x.dtype, device=x.device)
    err = load_library().deepv_conv3d_igemm_wgmma(
        x.data_ptr(), wk.data_ptr(), bv.data_ptr(), out.data_ptr(),
        b, ci, co, t_in, t_out, h, w, time_pad, *strides, plan.bn,
        int(plan.channels_last), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"igemm conv kernel launch failed: error {err}")
    if not plan.channels_last:
        launches += 1
    else:
        cl_launches += 1
    return out


def conv3d_tf32x3_planes(xp: torch.Tensor, wp: torch.Tensor, bias: torch.Tensor,
                         time_pad: int) -> torch.Tensor:
    """The ``tf32x3`` conv kernel alone, on x's planes ``[2, b, t_in, h, w,
    ci]`` (``split_tf32_cl``) and the weight's ``[2, 27, co, ci]``
    (``weight_planes``) with a float32 ``bias [co]``: y ``[b, co, t_in +
    time_pad - 2, h, w]`` float32."""
    global f32_launches
    _, b, t_in, h, w, ci = xp.shape
    co = wp.shape[2]
    t_out = t_in + time_pad - 2
    for name, t in (("xp", xp), ("wp", wp), ("bias", bias)):
        if (t.dtype != torch.float32 or not t.is_contiguous() or t.device != xp.device
                or t.device.type != "cuda"):
            raise ValueError(f"{name} must be contiguous float32 on xp's CUDA device")
    if tuple(wp.shape) != (2, 27, co, ci) or tuple(bias.shape) != (co,):
        raise ValueError(f"weight planes [2, 27, {co}, {ci}] and bias [{co}] expected, got "
                         f"{tuple(wp.shape)} and {tuple(bias.shape)}")
    out = torch.empty((b, co, t_out, h, w), dtype=torch.float32, device=xp.device)
    err = load_library().deepv_conv3d_igemm_tf32x3(
        xp.data_ptr(), wp.data_ptr(), bias.data_ptr(), out.data_ptr(), b, ci, co, t_in, t_out,
        h, w, time_pad, torch.cuda.current_stream(xp.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tf32x3 conv kernel launch failed: error {err}")
    f32_launches += 1
    return out
