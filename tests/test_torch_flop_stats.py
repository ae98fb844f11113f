"""The port's FLOP counter (``roofline.flop_stats``) and the hand
kernels' shape-only routes.

1. Fake tensors take each kernel wrapper's shape-only route: outputs of
   the kernel's shapes and dtypes, no launch counted, and the count of
   ``roofline.counts`` recorded; real CPU tensors still take the plain
   versions and never record.
2. Against the JAX package: at smoke width in float32, at a length below
   ``BLOCKWISE_THRESHOLD`` (both packages then run the same masked
   softmax products), the port's count of the training forward equals
   ``dot_flops`` of the JAX forward's compiled HLO for every attention
   family.  For the recurrent families the two count different work, and
   the difference is held exactly to its formula:
   - RWKV: the JAX scan body's dot ``o = r S`` is 2 a step, element and
     head column; the WKV kernel records ``WKV_FLOPS["fwd"]``;
   - Mamba: the JAX scan body's dot ``y = h c`` is 2 a step, channel and
     state; the selective-scan kernel records ``SCAN_FLOPS["fwd"]``; and
     the depthwise conv is a convolution, which ``dot_flops`` does not
     count and ``FlopCounterMode`` does (2 a step, channel and tap).
3. A closed form: full-width internlm2-1.8b's ``train_4k`` step.
"""
import dataclasses

import jax
import pytest
import torch

from repro import config as JC
from repro.launch import specs as JSP
from repro.models import forward_train as jforward_train
from repro.roofline.hlo_stats import dot_flops
from repro_torch import config as C
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import selective_scan as SS
from repro_torch.kernels import wkv as WK
from repro_torch.launch import specs as SP
from repro_torch.models import forward_train
from repro_torch.models.attention import BLOCKWISE_THRESHOLD
from repro_torch.roofline import counts
from repro_torch.roofline.flop_stats import flop_stats, step_flops
from repro_torch.util.device import is_fake

B, S = 2, 64
DENSE = ["internlm2-1.8b", "gemma3-1b", "granite-moe-1b-a400m",
         "deepseek-v2-236b", "phi3-medium-14b", "granite-34b",
         "internvl2-76b", "whisper-tiny"]
RECURRENT = ["jamba-1.5-large-398b", "rwkv6-3b"]


def _fake(*shape, dtype=torch.float32, device="cpu"):
    with SP.FAKE_MODE:
        return torch.empty(shape, dtype=dtype, device=device)


def _launches():
    return (FA.launches_fwd, FA.launches_bwd, PA.launches,
            SS.launches_fwd, SS.launches_bwd, WK.launches_fwd,
            WK.launches_bwd)


# ---------------------------------------------------------------------------
# 1. the kernels' shape-only routes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype, d, route", [
    (torch.bfloat16, 128, "sm90"), (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 256, "d256"), (torch.bfloat16, 192, "d192"),
    (torch.float32, 36, "simt")])
def test_flash_fake_route(dtype, d, route):
    """Forward and backward on fake CPU tensors (the autograd engine of a
    PyTorch built without CUDA cannot run a backward on CUDA tensors,
    fake or not); the forward on fake CUDA tensors too."""
    b, s, h, kh, window = 2, 300, 6, 3, 100
    before = _launches()
    q, k, v = (_fake(b, s, n, d, dtype=dtype) for n in (h, kh, kh))
    with SP.FAKE_MODE, flop_stats() as got:
        for t in (q, k, v):
            t.requires_grad_(True)
        out = ops.flash_attention(q, k, v, causal=True, window=window)
        out.float().sum().backward()
    assert is_fake(out) and out.shape == q.shape and out.dtype == dtype
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    pairs = counts.attended_pairs(s, True, window)
    assert got[f"flash_attention_{route}_fwd"] == 4 * b * h * d * pairs
    assert got[f"flash_attention_{route}_bwd"] == 10 * b * h * d * pairs
    qc, kc, vc = (_fake(b, s, n, d, dtype=dtype, device="cuda")
                  for n in (h, kh, kh))
    with SP.FAKE_MODE, counts.recording() as on_card:
        out = ops.flash_attention(qc, kc, vc, causal=True, window=window)
    assert out.device.type == "cuda" and out.shape == qc.shape
    assert on_card == {f"flash_attention_{route}_fwd":
                       got[f"flash_attention_{route}_fwd"]}
    assert _launches() == before
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        FA.flash_attention_fwd_cuda(*(_fake(1, 8, 2, 96,
                                            dtype=torch.bfloat16)
                                      for _ in range(3)))


@pytest.mark.parametrize("window", [0, 40, 4000])
def test_paged_fake_route_counts_the_capacity(window):
    b, h, kh, d, page, maxp = 3, 8, 2, 64, 16, 5
    q = _fake(b, 1, h, d, dtype=torch.bfloat16, device="cuda")
    kp = _fake(20, page, kh, d, dtype=torch.bfloat16, device="cuda")
    table = _fake(b, maxp, dtype=torch.int32, device="cuda")
    lengths = _fake(b, dtype=torch.int32, device="cuda")
    before = _launches()
    with SP.FAKE_MODE, counts.recording() as got:
        out = ops.paged_attention(q, kp, kp, table, lengths, window=window)
    assert is_fake(out) and out.shape == q.shape and out.dtype == q.dtype
    cap = maxp * page if not window else min(maxp * page, window)
    assert got == {"paged_attention": 4 * b * cap * h * d}
    assert _launches() == before


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_fake_route(x_dtype):
    b, s, d, n = 2, 512, 96, 16
    x = _fake(b, s, d, dtype=x_dtype)
    dt, bm, cm = _fake(b, s, d), _fake(b, s, n), _fake(b, s, n)
    a = _fake(d, n)
    before = _launches()
    with SP.FAKE_MODE, counts.recording() as got:
        y, hs = SS.forward(x, dt, bm, cm, a)
        grads = SS.backward(x, dt, bm, cm, a, hs, y)
        for t in (x, dt, bm, cm, a):
            t.requires_grad_(True)
        ops.selective_scan(x, dt, bm, cm, a).sum().backward()
    assert y.shape == (b, s, d) and y.dtype == torch.float32
    assert hs.shape == (b, 2, d, n)
    assert [tuple(g.shape) for g in grads] == [
        (b, s, d), (b, s, d), (b, s, n), (b, s, n), (d, n)]
    assert grads[0].dtype == x_dtype and x.grad.dtype == x_dtype
    assert got == {"selective_scan_fwd": 2 * 6 * b * s * d * n,
                   "selective_scan_bwd": 2 * 18 * b * s * d * n}
    assert _launches() == before
    with pytest.raises(ValueError, match="d_state"):
        SS.forward(x, dt, _fake(b, s, 8), _fake(b, s, 8), _fake(d, 8))


def test_wkv_fake_route():
    b, s, h, hs = 2, 768, 4, 64
    r, k, v, w = (_fake(b, s, h * hs) for _ in range(4))
    u = _fake(h, hs)
    before = _launches()
    with SP.FAKE_MODE, counts.recording() as got:
        o, states = WK.forward(r, k, v, w, u)
        grads = WK.backward(r, k, v, w, u, states, o)
        for t in (r, k, v, w, u):
            t.requires_grad_(True)
        ops.wkv(r, k, v, w, u).sum().backward()
    assert o.shape == (b, s, h * hs) and states.shape == (b, 3, h, hs, hs)
    assert [tuple(g.shape) for g in grads] == [(b, s, h * hs)] * 4 + [
        (h, hs)]
    assert u.grad.shape == (h, hs)
    elems = b * s * h * hs
    assert got == {"wkv_fwd": 2 * 5 * elems * hs,
                   "wkv_bwd": 2 * 14 * elems * hs}
    assert _launches() == before
    with pytest.raises(ValueError, match="head size"):
        WK.forward(*(_fake(b, s, 4 * 32) for _ in range(4)), _fake(4, 32))


def test_real_cpu_tensors_take_the_plain_versions():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 40, 2, 16), generator=gen) for _ in range(3))
    with counts.recording() as got:
        out = ops.flash_attention(q, k, v)
    assert not is_fake(out) and got == {}
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, v))
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_fwd_cuda(q, k, v)


# ---------------------------------------------------------------------------
# 2. against the JAX package's dot count
# ---------------------------------------------------------------------------
def _jax_forward_flops(jcfg) -> float:
    params = JSP.param_specs(jcfg)
    batch = JSP.train_input_specs(jcfg, JC.ShapeConfig("t", S, B, "train"))
    del batch["labels"]
    hlo = jax.jit(lambda p, x: jforward_train(p, jcfg, x)[0]).lower(
        params, batch).compile().as_text()
    return dot_flops(hlo)[0]


def _port_forward_flops(cfg):
    shape = C.ShapeConfig("t", S, B, "prefill")
    model = SP.param_specs(cfg, "cpu")
    batch = SP.train_input_specs(cfg, shape, "cpu")
    del batch["labels"]
    with SP.FAKE_MODE, torch.no_grad(), flop_stats() as got:
        forward_train(model, cfg, batch)
    return got


def _smoke(arch):
    return (dataclasses.replace(C.smoke_variant(C.get_arch(arch)),
                                dtype="float32"),
            dataclasses.replace(JC.smoke_variant(JC.get_arch(arch)),
                                dtype="float32"))


@pytest.mark.parametrize("arch", DENSE)
def test_forward_count_equals_jax_dot_flops(arch):
    assert S < BLOCKWISE_THRESHOLD
    cfg, jcfg = _smoke(arch)
    got = _port_forward_flops(cfg)
    assert set(got) <= {"aten.mm", "aten.bmm", "total"}   # no kernel
    assert got["total"] == _jax_forward_flops(jcfg)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_forward_count_differs_by_its_formula(arch):
    cfg, jcfg = _smoke(arch)
    got = _port_forward_flops(cfg)
    kinds = [m for m, _ in cfg.layer_kinds()]
    diff = 0
    if cfg.rwkv is not None:
        elems = B * S * cfg.d_model
        hs = cfg.rwkv.head_size
        n = kinds.count(C.RWKV)
        assert got["wkv_fwd"] == n * counts.WKV_FLOPS["fwd"] * elems * hs
        diff += n * (counts.WKV_FLOPS["fwd"] - 2) * elems * hs
    if cfg.mamba is not None:
        mc = cfg.mamba
        d_in = mc.expand * cfg.d_model
        n = kinds.count(C.MAMBA)
        steps = B * S * d_in
        assert got["selective_scan_fwd"] == (
            n * counts.SCAN_FLOPS["fwd"] * steps * mc.d_state)
        assert got["aten.convolution"] == n * 2 * steps * mc.d_conv
        diff += n * ((counts.SCAN_FLOPS["fwd"] - 2) * steps * mc.d_state
                     + 2 * steps * mc.d_conv)
    assert got["total"] - _jax_forward_flops(jcfg) == diff


# ---------------------------------------------------------------------------
# 3. a closed form at full width
# ---------------------------------------------------------------------------
def test_internlm2_train_step_closed_form():
    cfg = C.get_arch("internlm2-1.8b")
    shape = C.SHAPES["train_4k"]
    got = step_flops(cfg, shape, device="cpu")
    t = shape.global_batch * shape.seq_len
    d, hd, h, kh = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    attn = d * h * hd + 2 * d * kh * hd + h * hd * d      # q, k, v, o
    ffn = 3 * d * cfg.d_ff                                 # gate, up, down
    down = cfg.d_ff * d
    head = d * cfg.vocab_size
    # 2 t a weight a product: the layers forward, backward (2) and
    # recomputed under their checkpoints, but for the down projection,
    # whose output the backward does not need; the head forward and
    # backward
    mm = 2 * t * (cfg.num_layers * (4 * (attn + ffn) - down) + 3 * head)
    pairs = shape.seq_len * (shape.seq_len + 1) // 2        # causal
    per_layer = shape.global_batch * h * hd * pairs
    fwd = 2 * cfg.num_layers * 4 * per_layer               # + recompute
    bwd = cfg.num_layers * 10 * per_layer
    assert got == {"aten.mm": mm, "flash_attention_sm90_fwd": fwd,
                   "flash_attention_sm90_bwd": bwd,
                   "total": mm + fwd + bwd}


def test_flop_stats_nests_and_totals():
    q = _fake(1, 128, 2, 64, dtype=torch.bfloat16)
    with SP.FAKE_MODE, flop_stats() as outer:
        x = torch.empty((4, 8))
        x @ torch.empty((8, 3))
        with flop_stats() as inner:
            ops.flash_attention(q, q, q)
    assert inner == {"flash_attention_sm90_fwd": 4 * 2 * 64 * 128 * 129 // 2,
                     "total": 4 * 2 * 64 * 128 * 129 // 2}
    assert outer == {"aten.mm": 2 * 4 * 8 * 3,
                     "flash_attention_sm90_fwd": inner["total"],
                     "total": 2 * 4 * 8 * 3 + inner["total"]}


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-1b-a400m",
                                  "whisper-tiny"])
def test_train_count_does_not_depend_on_microbatches(arch):
    """Every product's work is linear in its rows, and an MoE layer's
    routing groups stay GROUP_SIZE tokens while a microbatch holds at
    least that many, so a step counts the same in 1 or 2 microbatches
    (``chip_smoke.py`` 16b counts in one)."""
    cfg = dataclasses.replace(C.smoke_variant(C.get_arch(arch)),
                              dtype="float32", remat=True)
    shape = C.ShapeConfig("t", 512, 4, "train")
    one = step_flops(cfg, shape, device="cpu")
    assert one == step_flops(cfg, shape, device="cpu", microbatches=2)
    assert one["total"] > 0
