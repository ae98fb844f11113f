"""The simulator's card path on the CPU: the plain timing epilogue against
the JAX package's own ``epilogue``, the epilogue wrapper's dispatch and
checks, the LRU scan's operand checks at the figure buckets' shapes, and
the walk lines made once a group of chunks.  Integer counters must be equal; the cycle sums are
float32 sums in other orders and agree within rtol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ndp_sim as JC
from repro.sim import simulator as JSIM
from repro.sim.mechanisms import registered_names
from repro_torch.configs import ndp_sim as TC
from repro_torch.kernels import lru_scan as LS
from repro_torch.kernels import ref
from repro_torch.kernels import sim_epilogue as SE
from repro_torch.sim import simulator as TSIM

RTOL = 1e-5
FLOAT_COUNTERS = ("trans", "walk_cyc")
CASES = {
    "ndp": ("ndp_machine", None),
    "cpu": ("cpu_machine", None),
    "zoo": ("zoo_machine", registered_names()),
}
#: the epilogue against the JAX package's: (machine case, chunk length,
#: a lane invalid throughout).  768 steps is the first cases'; 1 and 1,000
#: are not whole step tiles of the kernel's tiling
EPILOGUE_CASES = {
    "ndp": ("ndp", 768, False),
    "cpu": ("cpu", 768, False),
    "zoo": ("zoo", 768, False),
    "ndp_t1": ("ndp", 1, False),
    "cpu_t1000": ("cpu", 1000, False),
    "zoo_t1000": ("zoo", 1000, False),
    "ndp_lane_invalid": ("ndp", 768, True),
    "zoo_t1_lane_invalid": ("zoo", 1, True),
}


def cut(trace, n):
    return {k: (v[:, :n] if k != "pages" else v) for k, v in trace.items()}


def epilogue_inputs(smoke_trace, machine, names, t_len=768,
                    lane_invalid=False):
    """One chunk of 4 lanes (two workloads x 2 cores; the second goes
    invalid after 600 steps; with ``lane_invalid`` lane 1 is invalid
    throughout) through the plain scan, and per-lane data params that
    differ between lanes (seeded), with a multi-stack penalty on half of
    them so the co-location discount is reached."""
    jmach = getattr(JC, machine)(2)
    traces = [cut(smoke_trace(w, 2), t_len) for w in ("rnd", "xs")]

    def fuse(key):
        return np.stack([t[key].T for t in traces], 1).reshape(t_len, 4)

    vpn, off = fuse("vpn").astype(np.int32), fuse("off").astype(np.int32)
    work = fuse("work").astype(np.float32)
    frac = JSIM.FRAC_4K[2]
    is4k = (JSIM._hash_np(vpn >> JSIM.HUGE_SHIFT) % 1000) < int(frac * 1000)
    valid = np.ones((t_len, 4), bool)
    valid[600:, 2:] = False
    if lane_invalid:
        valid[:, 1] = False
    mt = {k: np.ascontiguousarray(np.broadcast_to(v, (4,) + v.shape))
          for k, v in JSIM._mech_arrays(names).items()}
    rng = np.random.default_rng(17)
    dp = {k: (np.float32(v) * (1 + 0.1 * rng.random(4))).astype(np.float32)
          for k, v in JSIM._data_params(jmach).items()}
    dp["stack_pen"] = np.float32([0.0, 12.5, 0.0, 30.0])
    m = len(names)
    q = (rng.random((m, 4)) * 40).astype(np.float32)

    shape = JSIM.machine_shape(jmach)
    tables = {n: (torch.zeros((4, m, s, w), dtype=torch.int32),
                  torch.zeros((4, m, s, w), dtype=torch.int32))
              for n, s, w in shape.tables}
    tmt = {k: torch.from_numpy(v) for k, v in mt.items()}
    pte = TSIM.walk_lines(torch.from_numpy(vpn), torch.from_numpy(is4k),
                          tmt["huge"], TSIM._walk_fns(names))
    packed = ref.lru_scan_ref(
        torch.from_numpy(vpn), torch.from_numpy(off), torch.from_numpy(is4k),
        torch.from_numpy(valid), pte, LS.mech_flags(tmt),
        torch.zeros((4, m), dtype=torch.int32), tables)
    return shape, packed, work, is4k, valid, q, mt, dp


@pytest.mark.parametrize("case", sorted(EPILOGUE_CASES))
def test_sim_epilogue_ref_matches_reference_epilogue(smoke_trace, case):
    which, t_len, lane_invalid = EPILOGUE_CASES[case]
    machine, mechs = CASES[which]
    names = tuple(mechs) if mechs else JSIM.DEFAULT_MECHS
    shape, packed, work, is4k, valid, q, mt, dp = epilogue_inputs(
        smoke_trace, machine, names, t_len, lane_invalid)
    n_hier = len(shape.hier)
    has_ctlb = any(n == "ctlb" for n, _, _ in shape.tables)

    _, epilogue = JSIM._build_model(shape, batched=True)
    want_cnt, want_cyc, want_mem = epilogue(
        jnp.asarray(packed.numpy()).swapaxes(1, 2), jnp.asarray(work),
        jnp.asarray(is4k), jnp.asarray(valid), jnp.asarray(q),
        {k: jnp.asarray(v) for k, v in mt.items()},
        {k: jnp.asarray(v) for k, v in dp.items()})

    tmt = {k: torch.from_numpy(v) for k, v in mt.items()}
    tdp = {k: torch.from_numpy(v) for k, v in dp.items()}
    cnt, cyc, mem_n = ref.sim_epilogue_ref(
        packed.transpose(1, 2), torch.from_numpy(work),
        torch.from_numpy(is4k), torch.from_numpy(valid), torch.from_numpy(q),
        tmt, tdp, n_hier, has_ctlb)
    assert sorted(cnt) == sorted(ref.COUNTERS) == sorted(want_cnt)
    for k in ref.COUNTERS:
        got, want = cnt[k].numpy(), np.asarray(want_cnt[k])
        assert got.dtype == want.dtype == np.float32, k
        if k in FLOAT_COUNTERS:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0,
                                       err_msg=k)
        else:
            assert np.array_equal(got, want), k
    np.testing.assert_allclose(cyc.numpy(), np.asarray(want_cyc), rtol=RTOL,
                               atol=0)
    assert np.array_equal(mem_n.numpy(), np.asarray(want_mem))
    # the chunk did real work: walks, PTE accesses, multi-stack penalties
    assert cnt["walks"].sum() > 0 and cnt["pte_mem"].sum() > 0
    if which == "zoo":
        assert cnt["trans"].shape == (17, 4)
    if lane_invalid:    # the invalid lane adds nothing
        assert float(cyc[:, 1].abs().sum()) == 0.0
        assert float(mem_n[:, 1].sum()) == 0.0
        assert all(float(v[:, 1].sum()) == 0.0 for v in cnt.values())

    # the wrapper's CPU path: the plain version, added into a (B, M, C)
    # state from the flag words and the parameter array
    b, c, m = 2, 2, len(names)
    clock = torch.full((b, m, c), 5.0)
    mem_accs = torch.ones((b, m))
    counters = {k: torch.zeros((b, m, c)) for k in ref.COUNTERS}
    before = SE.launches
    SE.sim_epilogue(
        packed, torch.from_numpy(work), torch.from_numpy(is4k),
        torch.from_numpy(valid),
        torch.from_numpy(np.ascontiguousarray(q.T[::c])),
        LS.mech_flags(tmt), SE.lane_params(tdp), clock, mem_accs, counters,
        n_hier=n_hier, has_ctlb=has_ctlb)
    assert SE.launches == before

    def unfuse(a):
        return a.reshape(m, b, c).transpose(0, 1)

    # q is per simulation: lanes 0-1 take q[:, 0], lanes 2-3 q[:, 2]
    q_sim = np.repeat(q[:, ::c], c, axis=1)
    cnt2, cyc2, mem2 = ref.sim_epilogue_ref(
        packed.transpose(1, 2), torch.from_numpy(work),
        torch.from_numpy(is4k), torch.from_numpy(valid),
        torch.from_numpy(q_sim), tmt, tdp, n_hier, has_ctlb)
    assert torch.equal(clock, 5.0 + unfuse(cyc2))
    assert torch.equal(mem_accs, 1.0 + unfuse(mem2).sum(dim=2))
    for k in ref.COUNTERS:
        assert torch.equal(counters[k], unfuse(cnt2[k])), k


def wrapper_args(b=1, c=2, m=3, t=8):
    lanes = b * c
    return dict(
        packed=torch.zeros((t, lanes, m), dtype=torch.int32),
        work=torch.ones((t, lanes)), is4k=torch.zeros((t, lanes), dtype=bool),
        valid=torch.ones((t, lanes), dtype=bool), q=torch.zeros((b, m)),
        flags=torch.full((lanes, m), 4 << ref.FLAG_N_PTE_SHIFT,
                         dtype=torch.int32),
        params=torch.ones((lanes, len(ref.EPILOGUE_PARAMS))),
        clock=torch.zeros((b, m, c)), mem_accs=torch.zeros((b, m)),
        counters={k: torch.zeros((b, m, c)) for k in ref.COUNTERS},
        n_hier=1, has_ctlb=False)


def test_sim_epilogue_wrapper_dispatch_and_checks(monkeypatch):
    args = wrapper_args()
    SE.sim_epilogue(**args)
    # 8 valid steps, every latency 1, no hit: each of the 4 PTE lines and
    # the data line costs l1 + (memory + stack penalty) = 3, the walk 12,
    # the translation l2tlb + walk = 13, the step work + 1 + 13 + (3 - l1)
    assert torch.equal(args["clock"], torch.full((1, 3, 2), 8 * 17.0))
    assert torch.equal(args["counters"]["walks"], torch.full((1, 3, 2), 8.0))
    assert torch.equal(args["counters"]["data_mem"],
                       torch.full((1, 3, 2), 8.0))
    # 2 lanes x 8 steps x (4 PTE + 1 data) memory accesses
    assert torch.equal(args["mem_accs"], torch.full((1, 3), 80.0))
    kw = dict(n_hier=1)
    check_args = {k: v for k, v in args.items()
                  if k not in ("n_hier", "has_ctlb")}
    SE._check(**check_args, **kw)
    with pytest.raises(ValueError, match="work must be torch.float32"):
        SE._check(**dict(check_args, work=args["work"].double()), **kw)
    with pytest.raises(ValueError, match="q must be"):
        SE._check(**dict(check_args, q=torch.zeros((2, 3))), **kw)
    with pytest.raises(ValueError, match="does not match"):
        SE._check(**dict(check_args, clock=torch.zeros((1, 3, 3))), **kw)
    with pytest.raises(ValueError, match="counters must be"):
        SE._check(**dict(check_args, counters={}), **kw)
    with pytest.raises(ValueError, match="n_hier"):
        SE._check(**check_args, n_hier=2)
    with pytest.raises(ValueError, match="contiguous"):
        SE._check(**dict(check_args, params=args["params"].T.contiguous().T),
                  **kw)
    with pytest.raises(ValueError, match="no sim_epilogue"):
        SE.sim_epilogue(**{k: (v.to("meta") if torch.is_tensor(v) else v)
                           for k, v in args.items() if k != "counters"},
                        counters={k: v.to("meta")
                                  for k, v in args["counters"].items()})

    # a CUDA tensor goes to the kernel, never to the plain version: with
    # no kernel to load the call raises and nothing is counted
    def no_plain(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    def no_card():
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(SE, "_plain", no_plain)
    monkeypatch.setattr(SE, "_lib", no_card)
    def on_card(v):
        return torch.zeros(v.shape, dtype=v.dtype, device="cuda")

    with FakeTensorMode():
        cuda = {k: (on_card(v) if torch.is_tensor(v) else v)
                for k, v in args.items() if k != "counters"}
        cuda["counters"] = {k: on_card(v)
                            for k, v in args["counters"].items()}
    before = SE.launches
    with pytest.raises(RuntimeError, match="no kernel library"):
        SE.sim_epilogue(**cuda)
    assert SE.launches == before
    with pytest.raises(ValueError, match="is on cpu"):
        SE._check(**dict({k: cuda[k] for k in check_args},
                         work=args["work"]), **kw)

    # the kernel's scratch and ticket words: one set a stream, grown when a
    # launch needs more, the tickets allocated zero (the kernel leaves
    # them zero)
    monkeypatch.setattr(SE, "_workspaces", {})
    cpu = torch.device("cpu")
    scratch, tickets = SE._workspace(cpu, 7, 100, 5)
    assert scratch.numel() >= 100 and scratch.dtype == torch.uint8
    assert tickets.numel() >= 5 and tickets.dtype == torch.int32
    assert not tickets.any()
    again = SE._workspace(cpu, 7, 50, 3)
    assert again[0] is scratch and again[1] is tickets
    grown = SE._workspace(cpu, 7, 200, 9)
    assert grown[0].numel() >= 200 and grown[1].numel() >= 9
    assert not grown[1].any()
    assert SE._workspace(cpu, 8, 10, 1)[0] is not grown[0]


def scan_operands(mach, m, lanes, t_len=1024, device="meta"):
    """The scan's operands for ``lanes`` lanes of ``mach`` and ``m``
    mechanisms, allocated on ``device`` (``meta``: shapes only)."""
    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return dict(vpn=zeros(t_len, lanes), off=zeros(t_len, lanes),
                is4k=zeros(t_len, lanes, dtype=torch.bool),
                valid=zeros(t_len, lanes, dtype=torch.bool),
                pte=zeros(t_len, lanes, m, 4), flags=zeros(lanes, m),
                stamp=zeros(lanes, m),
                tables={n: (zeros(lanes, m, s, w), zeros(lanes, m, s, w))
                        for n, (s, w) in TSIM._table_shapes(mach).items()})


@pytest.mark.parametrize("cores", [1, 4, 8])
@pytest.mark.parametrize("machine", sorted(CASES))
def test_scan_operands_of_figure_buckets(machine, cores):
    """A figure bucket (11 workloads at ``cores`` cores) gives the scan
    kernel operands it takes: every table of at most 64 ways (two a lane
    of the warp), the four tables every machine has, l2 and l3 together
    (cpu_machine only, the kernel's three-level variant), the
    cache-as-TLB on zoo_machine only."""
    mach = getattr(TC, CASES[machine][0])(cores)
    m = len(CASES[machine][1] or TSIM.DEFAULT_MECHS)
    args = scan_operands(mach, m, 11 * cores)
    LS._check(**args)
    tables = args["tables"]
    assert max(t.shape[-1] for t, _ in tables.values()) <= LS.MAX_WAYS
    assert {"l1tlb", "l2tlb", "pwc", "l1"} <= set(tables)
    assert ({"l2", "l3"} <= set(tables)) == (machine == "cpu")
    assert ("ctlb" in tables) == (machine == "zoo")
    assert set(tables) <= set(ref.SCAN_TABLES)


@pytest.mark.parametrize("fault,match", [
    ("wide", "at most 64 ways"),
    ("unknown", "unknown scan table"),
    ("flags_shape", "flags must be"),
    ("other_device", "valid is on meta"),
    ("pte_strided", "pte must be contiguous"),
    ("pte_unaligned", "16-byte aligned"),
])
def test_lru_scan_refuses_operands(fault, match):
    """Operands the kernel cannot take are refused before a launch."""
    args = scan_operands(TC.ndp_machine(1), 2, 2, t_len=8, device="cpu")
    tables = args["tables"]
    if fault == "wide":
        wide = torch.zeros((2, 2, 4, 65), dtype=torch.int32)
        tables["pwc"] = (wide, wide.clone())
    elif fault == "unknown":
        tables["l4"] = tables["l1"]
    elif fault == "flags_shape":
        args["flags"] = torch.zeros((2, 3), dtype=torch.int32)
    elif fault == "other_device":
        args["valid"] = args["valid"].to("meta")
    elif fault == "pte_strided":
        args["pte"] = torch.zeros((8, 2, 4, 2),
                                  dtype=torch.int32).transpose(-1, -2)
    else:
        flat = torch.zeros(8 * 2 * 2 * 4 + 1, dtype=torch.int32)
        args["pte"] = flat[1:].view(8, 2, 2, 4)
    with pytest.raises(ValueError, match=match):
        LS._check(**args)


def jax_walk_lines(vpn, is4k, huge, names):
    """The JAX runner's walk lines (``_chunk_runner``'s ``walk_lines``,
    src/repro/sim/simulator.py:743) composed from the JAX package's own
    walk functions and padding, per lane."""
    from repro.sim.mechanisms import specs_for
    radix = JSIM._pad_lines(JSIM.PT.radix4_walk_lines(vpn))
    per_mech = []
    for i, spec in enumerate(specs_for(names)):
        fn = spec.walk_fn
        if fn is None:
            lines = jnp.zeros_like(radix)
        elif fn is JSIM.PT.radix4_walk_lines:
            lines = radix
        else:
            lines = JSIM._pad_lines(fn(vpn))
        h = huge[None, :, i, None]
        per_mech.append(jnp.where(h & is4k[..., None], radix, lines))
    return np.asarray(jnp.stack(per_mech, axis=-2))


def test_walk_lines_once_a_group(smoke_trace, monkeypatch):
    """Walk lines made once for a group of chunks equal the per-chunk
    ``walk_lines`` and the JAX package's; every registered walk function
    (zoo machine, 17 mechanisms), groups of two chunks."""
    names = registered_names()
    chunk, m = 128, len(names)
    traces = [cut(smoke_trace(w, 2), n) for w, n in (("bfs", 700),
                                                     ("xs", 512))]
    lanes = 2 * 2
    monkeypatch.setattr(TSIM, "LINES_GROUP_BYTES",
                        2 * chunk * lanes * m * 4 * 4)
    bk, _ = TSIM._prepare([TSIM.SimJob(TC.zoo_machine(2), tr, names)
                           for tr in traces], None, chunk,
                          torch.device("cpu"))
    assert bk.group == 2 and bk.n_chunks == 6
    vpn, _, _, is4k, valid = bk.xs
    assert vpn.shape == (6 * chunk, lanes)
    assert bool(valid[699, :2].all()) and not bool(valid[700, :2].any())
    assert not bool(valid[512:, 2:].any())
    want = jax_walk_lines(jnp.asarray(vpn.numpy()), jnp.asarray(is4k.numpy()),
                          jnp.asarray(bk.mt_l["huge"].numpy()), names)
    made = []
    for i in range(bk.n_chunks):
        got = bk.chunk_lines(i)
        assert bk.lines[0] == i // 2
        sl = slice(i * chunk, (i + 1) * chunk)
        assert got.dtype == torch.int32 and got.is_contiguous()
        assert torch.equal(got, TSIM.walk_lines(vpn[sl], is4k[sl],
                                                bk.mt_l["huge"],
                                                bk.walk_fns))
        assert np.array_equal(got.numpy(), want[sl])
        made.append(bk.lines[1].data_ptr())
    assert len(set(made)) == 3              # one set of lines a group


def test_walk_lines_group_size():
    """The whole trace is one group at the full preset's 8,000-entry
    windows and at 65,536-entry windows, 11 workloads x 8 cores x 5
    mechanisms (88 lanes, chunks of 1,024)."""
    full = TC.PRESETS["full"]
    a_chunk = full.chunk * 88 * 5 * 4 * 4
    group = TSIM.LINES_GROUP_BYTES // a_chunk
    assert group * full.chunk >= full.trace_len
    assert group * full.chunk >= 65536
