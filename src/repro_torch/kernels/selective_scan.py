"""Wrapper of the hand-written CUDA selective-scan kernel (Mamba), forward
and backward.

The kernels (``csrc/selective_scan.cu``) replace the time recurrence of
the JAX package's ``mamba_apply`` (the ``step`` of
``src/repro/models/mamba.py:96-107``, run by ``jax.lax.scan`` inside
``chunked_scan``, ``src/repro/models/scan_utils.py:18``) and XLA's
autodiff of it.  It is not a Pallas kernel: PyTorch has no compiled
scan, an eager loop issues about 8 ops a step, and autograd through it
keeps every step's state.  ``ref.selective_scan_ref`` and
``ref.selective_scan_bwd_ref`` are the plain versions.

What it computes: x (B, S, D) float32 or bf16; dt (B, S, D), b and c
(B, S, N) and a (D, N) float32; from ``h = 0``, per step ``h = exp(dt
a) h + (dt x) b`` and ``y = sum_n h c``; y (B, S, D) float32, as the
JAX ``ys`` are.  N (``d_state``) is 16 (jamba) or 4 (``smoke_variant``);
anything else raises.

Design (the source says more).  The states lie across lanes: a
channel's N states are spread over N / 4 lanes of one warp, 4 states a
lane, so jamba's B 1, d_inner 16,384 gives
2,048 warps, about 16 an SM.  The sums over n (y; dx and d(dt)) are
transposing butterflies over a group of steps: one shuffle a step and
value, not log2 of the lanes.  The forward stages b_t, c_t and (dt_t,
dt_t x_t) through shared memory a tile of 16 steps at a time, loaded one
tile ahead, and stores the state at the start of every 256-step chunk,
(B, ceil(S / 256), D, N) float32, 16 MB at jamba's B 1, S 4,096.
:class:`SelectiveScan` saves the inputs and those states and nothing
else, so under ``torch.utils.checkpoint`` the forward runs twice a step
and the backward once.  The backward walks the chunks in reverse and
each twice from its stored state, 8-step sub-chunks at a time: once to
keep the state before every sub-chunk in a small global scratch (B, 32,
D, N), then a sub-chunk at a time in reverse, its states recomputed into
registers and the reverse recurrence run over them.  dx and d(dt) are
written per element; db and dc (sums over all D channels) and da (a sum
over batch and time) go through float32 partials (one per 128-channel
block, 67 MB at jamba's shape; one per batch row) that a second kernel
adds in a fixed order.  No atomics, so two backwards give the same bits.
The tiling lives in the source alone: :func:`geometry` asks it the sizes
of the states and the scratch, and :func:`occupancy` what the card makes
of the kernels.

Counters: :data:`launches_fwd` (one per :func:`forward`) and
:data:`launches_bwd` (one per :func:`backward`, which is the scan kernel
and the reduction of its partials), counted where they launch.
``kernels.ops.selective_scan`` sends CPU tensors to the plain version
and CUDA tensors here; nothing falls back.  Fake tensors
(``util.device.is_fake``, on any device) take a shape-only route: the
operands are checked as for a launch, nothing launches and no launch is
counted, and the outputs are fake tensors of the kernels' shapes (the
chunk states at one a 256-step chunk, as the source stores them).  A
launch and a fake call alike add ``roofline.counts.scan_flops`` (6 a
step, channel and state forward, 18 backward; the formula is
``counts.SCAN_FLOPS``) to the open ``roofline.counts`` recordings as
``selective_scan_<fwd|bwd>``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import SCAN_CHUNK
from repro_torch.roofline import counts
from repro_torch.util.device import is_fake

#: kernel launches since the counters were last reset
launches_fwd = 0
launches_bwd = 0

#: the state sizes the kernel is instantiated at
STATES = (4, 16)

_X_DTYPES = (torch.float32, torch.bfloat16)
_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("selective_scan")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.selective_scan_fwd_launch.argtypes = (
            [i32] * 3 + [ptr] * 7 + [i32] * 3 + [ptr])
        lib.selective_scan_fwd_launch.restype = i32
        lib.selective_scan_bwd_launch.argtypes = (
            [i32] * 3 + [ptr] * 15 + [i32] * 3 + [ptr])
        lib.selective_scan_bwd_launch.restype = i32
        lib.selective_scan_geometry.argtypes = (
            [i32] * 2 + [ctypes.POINTER(i32)] * 3)
        lib.selective_scan_geometry.restype = None
        lib.selective_scan_occupancy.argtypes = (
            [i32] * 3 + [ctypes.POINTER(i32)])
        lib.selective_scan_occupancy.restype = i32
        lib.selective_scan_error_string.argtypes = [i32]
        lib.selective_scan_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def check(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
          c: torch.Tensor, a: torch.Tensor) -> None:
    """The operands both versions take: x (B, S, D) float32 or bf16, dt
    (B, S, D), b and c (B, S, N) and a (D, N) float32, contiguous, on
    one device."""
    if x.dim() != 3 or x.dtype not in _X_DTYPES:
        raise ValueError(f"x must be (B, S, D) float32 or bf16, got "
                         f"{x.dtype} {tuple(x.shape)}")
    bsz, s, d = x.shape
    n = a.shape[-1]
    want = {"dt": (dt, (bsz, s, d)), "b": (b, (bsz, s, n)),
            "c": (c, (bsz, s, n)), "a": (a, (d, n))}
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("x", x), *((k, v[0]) for k, v in want.items())):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_kernel(x, dt, b, c, a) -> None:
    check(x, dt, b, c, a)
    if x.device.type != "cuda" and not is_fake(x):
        raise ValueError(f"the selective-scan kernel takes CUDA tensors, "
                         f"got {x.device}")
    if a.shape[-1] not in STATES:
        raise ValueError(f"no selective-scan kernel for d_state "
                         f"{a.shape[-1]}: it is built for {STATES}")
    if x.numel() == 0:
        raise ValueError("the selective scan needs B, S and D > 0")


def _raise(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().selective_scan_error_string(err).decode()
        raise RuntimeError(f"selective_scan {what} failed: "
                           f"CUDA error {err} ({msg})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def geometry(s: int, d: int) -> Tuple[int, int, int]:
    """The kernels' tiling at S steps and D channels, from the source:
    (chunks, the states a row the forward keeps; channel blocks, the db /
    dc partials a step; sub-chunks a chunk, the states a row the backward
    keeps in its scratch)."""
    out = [ctypes.c_int() for _ in range(3)]
    _lib().selective_scan_geometry(s, d, *(ctypes.byref(v) for v in out))
    return out[0].value, out[1].value, out[2].value


def occupancy(n: int, x_dtype: torch.dtype) -> dict:
    """What the current card makes of the kernels at d_state ``n``: for
    the forward and the backward, threads a block, resident blocks an SM,
    registers a thread and local (spill) bytes a thread."""
    out = (ctypes.c_int * 8)()
    _raise(_lib().selective_scan_occupancy(
        torch.cuda.current_device(), n, int(x_dtype == torch.bfloat16),
        out), "occupancy query")
    keys = ("threads", "blocks_per_sm", "registers", "local_bytes")
    return {"fwd": dict(zip(keys, out[:4])), "bwd": dict(zip(keys, out[4:]))}


def forward(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, a: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward on checked operands: (y, the chunk states)."""
    global launches_fwd
    _check_kernel(x, dt, b, c, a)
    bsz, s, d = x.shape
    n = a.shape[-1]
    if is_fake(x):
        counts.record("selective_scan_fwd", counts.scan_flops(
            bsz, s, d, n, False))
        return (x.new_empty((bsz, s, d), dtype=torch.float32),
                x.new_empty((bsz, -(-s // SCAN_CHUNK), d, n),
                            dtype=torch.float32))
    lib = _lib()
    y = torch.empty((bsz, s, d), dtype=torch.float32, device=x.device)
    hs = torch.empty((bsz, geometry(s, d)[0], d, n), dtype=torch.float32,
                     device=x.device)
    err = lib.selective_scan_fwd_launch(
        x.device.index, n, int(x.dtype == torch.bfloat16), x.data_ptr(),
        dt.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(),
        y.data_ptr(), hs.data_ptr(), bsz, s, d, _stream(x))
    _raise(err, "forward kernel launch")
    launches_fwd += 1
    counts.record("selective_scan_fwd", counts.scan_flops(bsz, s, d, n,
                                                          False))
    return y, hs


def backward(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, a: torch.Tensor, hs: torch.Tensor,
             dy: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Launch the backward (the scan kernel, then the reduction of its
    partials): (dx in x's dtype, d(dt), db, dc, da)."""
    global launches_bwd
    _check_kernel(x, dt, b, c, a)
    bsz, s, d = x.shape
    n = a.shape[-1]
    if is_fake(x):
        counts.record("selective_scan_bwd", counts.scan_flops(
            bsz, s, d, n, True))
        return (x.new_empty((bsz, s, d)),
                *(x.new_empty(shape, dtype=torch.float32) for shape in (
                    (bsz, s, d), (bsz, s, n), (bsz, s, n), (d, n))))
    # the kernel reads b and c as float4s; a view that starts off a
    # 16-byte boundary (a split of a B S == 1 projection) is copied
    b, c = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (b, c))
    lib = _lib()
    nc, blocks, subs = geometry(s, d)
    for name, t, shape in (("hs", hs, (bsz, nc, d, n)),
                           ("dy", dy, (bsz, s, d))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} "
                             f"on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((bsz, s, d), dtype=x.dtype, device=dev)
    ddt = torch.empty((bsz, s, d), **f32)
    db = torch.empty((bsz, s, n), **f32)
    dc = torch.empty((bsz, s, n), **f32)
    da = torch.empty((d, n), **f32)
    part_bc = torch.empty((blocks, bsz, s, 2 * n), **f32)
    part_a = torch.empty((bsz, d, n), **f32)
    sub_h = torch.empty((bsz, subs, d, n), **f32)
    err = lib.selective_scan_bwd_launch(
        dev.index, n, int(x.dtype == torch.bfloat16), x.data_ptr(),
        dt.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(),
        hs.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        db.data_ptr(), dc.data_ptr(), da.data_ptr(), part_bc.data_ptr(),
        part_a.data_ptr(), sub_h.data_ptr(), bsz, s, d, _stream(x))
    _raise(err, "backward kernel launch")
    launches_bwd += 1
    counts.record("selective_scan_bwd", counts.scan_flops(bsz, s, d, n,
                                                          True))
    return dx, ddt, db, dc, da


class SelectiveScan(torch.autograd.Function):
    """The kernel pair for autograd.  Saves x, dt, b, c, a and the chunk
    states: no per-step state is ever stored."""

    @staticmethod
    def forward(ctx, x, dt, b, c, a):
        y, hs = forward(x, dt, b, c, a)
        ctx.save_for_backward(x, dt, b, c, a, hs)
        return y

    @staticmethod
    def backward(ctx, dy):
        return backward(*ctx.saved_tensors, dy.contiguous())
