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

Design (the source says more).  The chunks run side by side: every
chunk's state at its start is tied to the ones before it only through
``S_{c+1} = diag(W_c) S_c + dS_c`` (W_c the product of the chunk's w,
dS_c its end state from 0), and the backward's gradient of the state
likewise in reverse; every factor is a product of w <= 1, so nothing is
divided by w.  The forward is three kernels: each chunk's dS_c and W_c
(a block a (row, head, chunk) and its whole hs x hs state, a thread 8
rows x 4 columns), the chain over chunks (an element a thread; it
writes the states (B, ceil(S / 256), H, hs, hs) float32, the first 0),
and each chunk walked from its state, o out.  :class:`WKV` saves the
inputs and those states and nothing else, so under
``torch.utils.checkpoint`` the forward runs twice a step and the
backward once.  The backward is four: the same two first stages for the
gradient of the state (G at every chunk's end), then each chunk from
its stored state and G_end by a cluster of 4 blocks of 16 columns (a
thread 2 rows x 4 columns; the state every 16 steps in a global scratch,
every 4 in registers, the 4-step sub-chunks' states in registers, G's
reverse recurrence), dr, dk, dw summed over the head's columns in the
owning block of the cluster, stored there through distributed shared
memory (`st.async`, counted on its mbarrier), in a fixed order and
written once, dv over rows by butterflies and shared memory, and a
small kernel that adds du's partials a (batch row, chunk) in order.  Inputs reach
shared memory by cp.async, a tile of 16 steps ahead.  No atomics, so two
backwards give the same bits.  :func:`chain` runs the first two stages
alone (the chunk states, or G at every chunk's end) and
:func:`occupancy` says what the card makes of the kernels.

Counters: :data:`launches_fwd` (one per :func:`forward`, its three
kernels) and :data:`launches_bwd` (one per :func:`backward`, its four),
counted where they launch; :func:`chain` counts nothing.
``kernels.ops.wkv`` sends CPU tensors to the plain version and CUDA
tensors here; nothing falls back.  Fake tensors (``util.device.is_fake``,
on any device) take a shape-only route: the operands are checked as for
a launch, nothing launches and no launch is counted, and the outputs are
fake tensors of the kernels' shapes (the states at one a 256-step
chunk).  A launch and a fake call alike add ``roofline.counts.wkv_flops``
(``counts.WKV_FLOPS`` a state element and step) to the open
``roofline.counts`` recordings as ``wkv_<fwd|bwd>``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import SCAN_CHUNK, wkv_check_length
from repro_torch.roofline import counts
from repro_torch.util.device import is_fake

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
        lib.wkv_chain_launch.argtypes = [i32] * 3 + [ptr] * 6 + [i32] * 3 + [
            ptr]
        lib.wkv_chain_launch.restype = i32
        lib.wkv_fwd_launch.argtypes = [i32] * 2 + [ptr] * 7 + [i32] * 3 + [ptr]
        lib.wkv_fwd_launch.restype = i32
        lib.wkv_bwd_launch.argtypes = ([i32] * 2 + [ptr] * 13 + [i32] * 4
                                       + [ptr])
        lib.wkv_bwd_launch.restype = i32
        lib.wkv_geometry.argtypes = [i32] * 2 + [ctypes.POINTER(i32)] * 3
        lib.wkv_geometry.restype = None
        lib.wkv_occupancy.argtypes = [i32, i32, ctypes.POINTER(i32)]
        lib.wkv_occupancy.restype = i32
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
    if r.device.type != "cuda" and not is_fake(r):
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
    """The kernels copy r, k, v, w and do 16 bytes at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _same(name: str, t: torch.Tensor, shape, like: torch.Tensor) -> None:
    if (t.dtype != torch.float32 or tuple(t.shape) != tuple(shape)
            or t.device != like.device or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous float32 {tuple(shape)} "
                         f"on {like.device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def geometry(s: int, hs: int) -> Tuple[int, int, int]:
    """The kernels' tiling at S steps and head size hs, from the source:
    (chunks, the states a (row, head) the forward keeps; column blocks a
    head, the backward's cluster; states a chunk the backward keeps in
    its scratch)."""
    out = [ctypes.c_int() for _ in range(3)]
    _lib().wkv_geometry(s, hs, *(ctypes.byref(x) for x in out))
    return out[0].value, out[1].value, out[2].value


def occupancy(hs: int) -> Dict[str, dict]:
    """What the current card makes of the kernels at head size hs: for
    the chunk walk forward (F1) and in reverse (B1), the walk of each
    chunk (F3) and the backward's per-chunk kernel (B3), threads a block,
    resident blocks an SM, registers and local (spill) bytes a thread;
    and B3's clusters resident on the whole card."""
    out = (ctypes.c_int * 17)()
    _raise(_lib().wkv_occupancy(torch.cuda.current_device(), hs, out),
           "occupancy query")
    keys = ("threads", "blocks_per_sm", "registers", "local_bytes")
    got = {name: dict(zip(keys, out[4 * q:4 * q + 4]))
           for q, name in enumerate(("f1", "b1", "f3", "b3"))}
    got["b3"]["clusters"] = out[16]
    return got


def chain(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
          u: torch.Tensor, reverse: bool) -> torch.Tensor:
    """The first two stages on checked operands: forward (a = k, b = v)
    the state at every chunk's start, the forward's ``states``; reverse
    (a = r, b = do) the gradient of the state after every chunk's last
    step, G_end.  (B, chunks, H, hs, hs) float32; counts nothing."""
    _check_kernel(a, b, b, w, u)
    bsz, s, _ = a.shape
    nh, hs = u.shape
    nc = geometry(s, hs)[0]
    a, b, w = _aligned(a), _aligned(b), _aligned(w)
    f32 = dict(dtype=torch.float32, device=a.device)
    out = torch.empty((bsz, nc, nh, hs, hs), **f32)
    delta = torch.empty((bsz, nc - 1, nh, hs, hs), **f32)
    decay = torch.empty((bsz, nc - 1, nh, hs), **f32)
    err = _lib().wkv_chain_launch(
        a.device.index, hs, int(reverse), a.data_ptr(), b.data_ptr(),
        w.data_ptr(), delta.data_ptr(), decay.data_ptr(), out.data_ptr(),
        bsz, s, nh, _stream(a))
    _raise(err, "chain launch")
    return out


def forward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward on checked operands (the chunk walks, the
    chain, each chunk from its state): (o, the chunk states)."""
    global launches_fwd
    _check_kernel(r, k, v, w, u)
    bsz, s, d = r.shape
    nh, hs = u.shape
    if is_fake(r):
        counts.record("wkv_fwd", counts.wkv_flops(r.numel(), hs, False))
        return (r.new_empty((bsz, s, d)),
                r.new_empty((bsz, -(-s // SCAN_CHUNK), nh, hs, hs)))
    states = chain(k, v, w, u, reverse=False)
    r, k, v, w = (_aligned(t) for t in (r, k, v, w))
    o = torch.empty((bsz, s, d), dtype=torch.float32, device=r.device)
    err = _lib().wkv_fwd_launch(
        r.device.index, hs, r.data_ptr(), k.data_ptr(), v.data_ptr(),
        w.data_ptr(), u.data_ptr(), states.data_ptr(), o.data_ptr(), bsz,
        s, nh, _stream(r))
    _raise(err, "forward kernel launch")
    launches_fwd += 1
    counts.record("wkv_fwd", counts.wkv_flops(r.numel(), hs, False))
    return o, states


def backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, states: torch.Tensor,
             do: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Launch the backward (the chunk walks of G and its chain, each
    chunk from its stored state and G_end, du's fold): (dr, dk, dv, dw,
    du), float32."""
    global launches_bwd
    _check_kernel(r, k, v, w, u)
    bsz, s, d = r.shape
    nh, hs = u.shape
    if is_fake(r):
        counts.record("wkv_bwd", counts.wkv_flops(r.numel(), hs, True))
        return (*(r.new_empty((bsz, s, d)) for _ in range(4)),
                r.new_empty((nh, hs)))
    nc, blocks, ckpts = geometry(s, hs)
    _same("states", states, (bsz, nc, nh, hs, hs), r)
    _same("do", do, (bsz, s, d), r)
    g_end = chain(r, do, w, u, reverse=True)
    r, k, v, w, do = (_aligned(t) for t in (r, k, v, w, do))
    f32 = dict(dtype=torch.float32, device=r.device)
    dv = torch.empty((bsz, s, d), **f32)
    drkw = torch.empty((3, bsz, s, d), **f32)
    du = torch.empty((nh, hs), **f32)
    part_u = torch.empty((bsz, nc, d), **f32)
    ckpt = torch.empty((bsz, nc, nh, blocks, ckpts, hs, 16), **f32)
    err = _lib().wkv_bwd_launch(
        r.device.index, hs, r.data_ptr(), k.data_ptr(), v.data_ptr(),
        w.data_ptr(), u.data_ptr(), states.data_ptr(), g_end.data_ptr(),
        do.data_ptr(), dv.data_ptr(), drkw.data_ptr(), du.data_ptr(),
        part_u.data_ptr(), ckpt.data_ptr(), bsz, s, nh, ckpts, _stream(r))
    _raise(err, "backward kernel launch")
    launches_bwd += 1
    counts.record("wkv_bwd", counts.wkv_flops(r.numel(), hs, True))
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
