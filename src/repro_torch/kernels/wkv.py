"""Wrapper of the hand-written CUDA WKV kernels (RWKV6), forward and
backward.

The kernels (``csrc/wkv.cu``) replace the time recurrence of the JAX
package's ``rwkv_apply`` (the ``step`` of
``src/repro/models/rwkv.py:105-111``, run by ``jax.lax.scan`` inside
``chunked_scan``, ``src/repro/models/scan_utils.py:18``) and XLA's
autodiff of it.  It is not a Pallas kernel: PyTorch has no compiled
scan, an eager loop issues about 6 ops a step, and autograd through it
keeps every step's (B, H, hs, hs) state.  ``ref.wkv_ref`` and
``ref.wkv_bwd_ref`` are the plain versions.

What it computes: r, k, v, w (B, S, H hs) and u (H, hs), all float32;
per batch row and head, from ``S_0 = 0``, ``a_t = k_t v_t^T``, ``o_t[j]
= sum_i r_t[i] (S_t[i, j] + u[i] a_t[i, j])`` and ``S_{t+1} = diag(w_t)
S_t + a_t``; o (B, S, H hs) float32.  hs is 64 (rwkv6-3b) or 16
(``smoke_variant``); anything else raises.  S follows the JAX chunk
rule: up to 256, or a whole number of 256-step chunks.

Design (the source says more).  A block holds 16 columns of one (row,
head)'s state, so rwkv6-3b's 40 heads of 64 give 4 blocks a head: 320
blocks at B 2, 160 at B 1.  The forward spreads a column's 64 rows over
8 lanes, stages r, k, w and v a tile of 32 steps at a time through
shared memory, sums a lane's rows for 8 steps at once and folds them
over the lanes by a transposing butterfly, and stores the state at the
start of every 256-step chunk, (B, ceil(S / 256), H, hs, hs) float32.
:class:`WKV` saves the inputs and those states and nothing else, so
under ``torch.utils.checkpoint`` the forward runs twice a step and the
backward once.  The backward gives each thread a row of the block's 16
columns, walks the chunks in reverse, and each twice from its stored
state: once to keep the state every 8 steps in a per-block global
scratch, then an 8-step sub-chunk at a time in reverse, its inputs and
recomputed states in shared memory and the reverse recurrence of the
state's gradient run over them in registers.  dv sums over rows through
shared memory in a fixed order; dr, dk, dw (sums over columns) go out as
one float32 partial a column block, and du (over batch and time) as one
a (row, column block); a second kernel adds them in a fixed order.  No
atomics, so two backwards give the same bits.

Counters: :data:`launches_fwd` (one per :func:`forward`) and
:data:`launches_bwd` (one per :func:`backward`, which is the recurrence
kernel and the reduction of its partials), counted where they launch.
``kernels.ops.wkv`` sends CPU tensors to the plain version and CUDA
tensors here; nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import wkv_check_length

#: kernel launches since the counters were last reset
launches_fwd = 0
launches_bwd = 0

#: the head sizes the kernels are instantiated at
HEAD_SIZES = (16, 64)

_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("wkv")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.wkv_fwd_launch.argtypes = [i32] * 2 + [ptr] * 7 + [i32] * 3 + [ptr]
        lib.wkv_fwd_launch.restype = i32
        lib.wkv_bwd_launch.argtypes = ([i32] * 2 + [ptr] * 13 + [i32] * 3
                                       + [ptr])
        lib.wkv_bwd_launch.restype = i32
        lib.wkv_geometry.argtypes = [i32] * 2 + [ctypes.POINTER(i32)] * 3
        lib.wkv_geometry.restype = None
        lib.wkv_error_string.argtypes = [i32]
        lib.wkv_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def check(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          w: torch.Tensor, u: torch.Tensor) -> None:
    """The operands both versions take: r, k, v, w (B, S, H hs) and u (H,
    hs), float32, contiguous, on one device; S by the chunk rule."""
    if u.dim() != 2 or u.dtype != torch.float32:
        raise ValueError(f"u must be (H, hs) float32, got {u.dtype} "
                         f"{tuple(u.shape)}")
    if r.dim() != 3:
        raise ValueError(f"r must be (B, S, H hs), got {tuple(r.shape)}")
    shape = (r.shape[0], r.shape[1], u.shape[0] * u.shape[1])
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    wkv_check_length(r.shape[1])


def _check_kernel(r, k, v, w, u) -> None:
    check(r, k, v, w, u)
    if r.device.type != "cuda":
        raise ValueError(f"the WKV kernel takes CUDA tensors, got "
                         f"{r.device}")
    if u.shape[1] not in HEAD_SIZES:
        raise ValueError(f"no WKV kernel for head size {u.shape[1]}: it is "
                         f"built for {HEAD_SIZES}")
    if r.numel() == 0:
        raise ValueError("the WKV recurrence needs B, S and H > 0")


def _raise(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().wkv_error_string(err).decode()
        raise RuntimeError(f"wkv {what} failed: CUDA error {err} ({msg})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernels read v and do as float4s."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def geometry(s: int, hs: int) -> Tuple[int, int, int]:
    """The kernels' tiling at S steps and head size hs, from the source:
    (chunks, the states a (row, head) the forward keeps; column blocks a
    head; scratch floats a block of the backward)."""
    out = [ctypes.c_int() for _ in range(3)]
    _lib().wkv_geometry(s, hs, *(ctypes.byref(x) for x in out))
    return out[0].value, out[1].value, out[2].value


def forward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward on checked operands: (o, the chunk states)."""
    global launches_fwd
    _check_kernel(r, k, v, w, u)
    lib = _lib()
    bsz, s, d = r.shape
    nh, hs = u.shape
    o = torch.empty((bsz, s, d), dtype=torch.float32, device=r.device)
    states = torch.empty((bsz, geometry(s, hs)[0], nh, hs, hs),
                         dtype=torch.float32, device=r.device)
    err = lib.wkv_fwd_launch(
        r.device.index, hs, r.data_ptr(), k.data_ptr(), v.data_ptr(),
        w.data_ptr(), u.data_ptr(), o.data_ptr(), states.data_ptr(), bsz,
        s, nh, _stream(r))
    _raise(err, "forward kernel launch")
    launches_fwd += 1
    return o, states


def backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, states: torch.Tensor,
             do: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Launch the backward (the recurrence kernel, then the reduction of
    its partials): (dr, dk, dv, dw, du), float32."""
    global launches_bwd
    _check_kernel(r, k, v, w, u)
    lib = _lib()
    bsz, s, d = r.shape
    nh, hs = u.shape
    nc, blocks, scratch = geometry(s, hs)
    for name, t, shape in (("states", states, (bsz, nc, nh, hs, hs)),
                           ("do", do, (bsz, s, d))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != r.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} "
                             f"on {r.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    v, do = _aligned(v), _aligned(do)
    f32 = dict(dtype=torch.float32, device=r.device)
    dv = torch.empty((bsz, s, d), **f32)
    drkw = torch.empty((3, bsz, s, d), **f32)
    du = torch.empty((nh, hs), **f32)
    part_rkw = torch.empty((3, blocks, bsz, s, d), **f32)
    part_u = torch.empty((bsz, blocks, d), **f32)
    work = torch.empty((bsz * nh * blocks, scratch), **f32)
    err = lib.wkv_bwd_launch(
        r.device.index, hs, r.data_ptr(), k.data_ptr(), v.data_ptr(),
        w.data_ptr(), u.data_ptr(), states.data_ptr(), do.data_ptr(),
        dv.data_ptr(), drkw.data_ptr(), du.data_ptr(), part_rkw.data_ptr(),
        part_u.data_ptr(), work.data_ptr(), bsz, s, nh, _stream(r))
    _raise(err, "backward kernel launch")
    launches_bwd += 1
    return drkw[0], drkw[1], dv, drkw[2], du


class WKV(torch.autograd.Function):
    """The kernel pair for autograd.  Saves r, k, v, w, u and the chunk
    states: no per-step state is ever stored."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        o, states = forward(r, k, v, w, u)
        ctx.save_for_backward(r, k, v, w, u, states)
        return o

    @staticmethod
    def backward(ctx, do):
        return backward(*ctx.saved_tensors, do.contiguous())
