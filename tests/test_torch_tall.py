"""K3 on 64-row wgmma tiles (``csrc/fused_gram_tall.cu``) on the CPU: its
weight stream read back by wgmma's core-matrix layout, an emulation of
its k-order held to the plain version, its shared-memory plan, the
routing that sends a K3 call there, and the name the benchmark finds it
by. The kernel itself is held to the plain version on a card
(``tests/test_torch_cuda.py``, ``-k tall``).

Tolerances: the emulation and the plain version differ only in fp32
summation order, so values agree within 1e-5 of |logL| + c/2 (the gram
form's cancellation scale) and gradients pass the gradient gate of
``bench_mcmc.py`` (``grad_gate_violation`` ≤ 0).
"""

import os
import re

import numpy as np
import pytest
import torch
from _torch_tall import emulate_tall, unpack_tall

from port_bench.readers import KERNELS
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.ops.fold import _split_hi_lo, bf16_round, gram_fold, noise_scale, obs_tensor
from tpu21cmvae_torch.ops.kernels import fused_loglik
from tpu21cmvae_torch.ops.kernels._build import CSRC
from tpu21cmvae_torch.ops.kernels._common import MAX_SHARED_BYTES, TIER_CODE
from tpu21cmvae_torch.ops.kernels.fused_loglik import (
    TALL_ROWS,
    TALL_WAVES,
    _tall_args,
    _tall_arena,
    k3_batch_route,
    loglik_grad_gram_reference,
    make_fused_loglik_grad_gram,
    make_fused_loglik_gram,
    pack_tall,
    tall_crossover,
    tall_plan,
    tall_stages,
)
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig
from tpu21cmvae_torch.utils.metrics import grad_gate_violation
from tpu21cmvae_torch.utils.profiling import recording

FLAGSHIP = (288, 352, 288, 224)
# the flagship, a narrow network with widths that need padding, the
# flagship's shape at a quarter of its width, and a trunk of two layers
TALL_WIDTHS = [FLAGSHIP, (32, 48, 32, 24), (72, 88, 72, 56), (64, 40)]
# the pair the kernel is built for, and the bf16 pairs it leaves to the 16-row kernel
TALL_PAIRS = [("high", "default")]
OTHER_PAIRS = [("high", "high"), ("default", "default"), ("default", "high")]
H100_SMS = 132


@pytest.fixture(scope="module")
def port_model(splits):
    cache = {}

    def get(hidden):
        if hidden not in cache:
            m = DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=hidden),
                               seed=sum(hidden), device="cpu")
            sig = m.predict(splits.par_test[0])
            obs = (sig + np.random.default_rng(5).normal(0, 5.0, sig.shape)).astype(np.float32)
            cache[hidden] = (m, obs)
        return cache[hidden]

    return get


def _k3(m, obs, tiers, **kw):
    return make_fused_loglik_grad_gram(m.config, m.normalizer, obs, 25.0, precision=tiers[0],
                                       grad_precision=tiers[1], device="cpu", **kw)


def _raw(splits, n=37):
    raw = np.asarray(splits.par_test[:n], np.float32).copy()
    raw[5, 2] = 0.0  # the fx == 0 clamp
    return torch.as_tensor(raw)


def _tier_parts(w, tier):
    return _split_hi_lo(w) if tier == "bf16x3" else (bf16_round(w),)


@pytest.mark.parametrize("hidden", TALL_WIDTHS)
@pytest.mark.parametrize("tiers", TALL_PAIRS)
def test_tall_stream_unpacks_to_the_tier_parts(port_model, hidden, tiers):
    """Read back by the core-matrix layout, the stream holds each trunk
    layer i ≥ 1 and ``G`` at the value tier and each ``W_iᵀ`` at the
    backward tier, in stage order, bit for bit, zero-padded to multiples
    of 16; every stream element is read once, and the wrapper's stream is
    :func:`pack_tall` of its operands."""
    m, obs = port_model(hidden)
    fn = _k3(m, obs, tiers)
    ops = fn.operands(m.params)
    assert fn.tall_plan is not None and ops.tall.dtype == torch.bfloat16
    assert torch.equal(ops.tall, pack_tall(ops))
    trunk, G, _, _ = gram_fold(m.params, m.normalizer, obs_tensor(obs, 451, device="cpu"),
                               noise_scale(25.0, 451, device="cpu"))
    want = ([(layer["w"], ops.tier) for layer in trunk[1:]] + [(G, ops.tier)]
            + [(layer["w"].T, ops.grad_tier) for layer in reversed(trunk[1:])])
    got = unpack_tall(ops.tall, ops.widths, ops.tier, ops.grad_tier)
    assert len(got) == len(want) == 2 * len(hidden) - 1
    for stage, (w, tier) in zip(got, want, strict=True):
        k, n = w.shape
        assert stage.shape[1:] == (-(-k // 16) * 16, -(-n // 16) * 16)
        for part, exact in zip(stage, _tier_parts(w, tier), strict=True):
            assert torch.equal(part[:k, :n], exact)
        assert not stage[:, k:].any() and not stage[:, :, n:].any()


@pytest.mark.parametrize("hidden", TALL_WIDTHS)
@pytest.mark.parametrize("tiers", TALL_PAIRS)
def test_tall_emulation_matches_plain(port_model, splits, hidden, tiers):
    """Through the stream, in the tile's k-order (each k-step's products
    summed alone, then added to the running fp32 sum), K3 equals
    :func:`loglik_grad_gram_reference` within fp32 summation order: values
    within 1e-5 of |logL| + c/2, gradients under the gradient gate, the
    fx == 0 slot exactly 0 (37 rows)."""
    m, obs = port_model(hidden)
    ops = _k3(m, obs, tiers).operands(m.params)
    x = _raw(splits)
    (v, g), (vp, gp) = emulate_tall(ops, x), loglik_grad_gram_reference(ops, x)
    assert v.shape == (37,) and g.shape == (37, 7)
    assert torch.isfinite(v).all() and torch.isfinite(g).all()
    scale = vp.abs() + 0.5 * abs(float(ops.c))
    assert bool(((v - vp).abs() <= 1e-5 * scale).all())
    assert grad_gate_violation(g.numpy(), gp.numpy()) <= 0.0
    assert g[5, 2] == 0.0


@pytest.mark.parametrize("hidden", TALL_WIDTHS)
@pytest.mark.parametrize("tiers", [("bf16x3", "bf16")])
def test_tall_plan_keeps_live_tiles_apart(hidden, tiers):
    """At every stage the tiles the kernel reads and writes lie inside the
    arena and apart: a layer's input and output; at the gram head its
    input, ``h`` in fp32 (the last trunk layer's output) and ``e``; at the
    first backward layer ``e`` and its output. The CTA fits shared memory
    with 2 to 12 ring slots of the largest block."""
    widths = (7, *hidden)
    n = len(hidden)
    plan = tall_plan(widths, *tiers)
    pf, pb = TIER_CODE[tiers[0]], TIER_CODE[tiers[1]]
    assert plan.smem <= MAX_SHARED_BYTES and 2 <= plan.ring <= 12
    assert (plan.arena, plan.in_off, plan.out_off) == (lambda a: (a[0], tuple(a[1]), tuple(a[2])))(
        _tall_arena(widths, pf, pb))

    def tile(w, parts):
        return 2 * TALL_ROWS * (-(-w // 16) * 16) * parts

    def f32(w):
        return 4 * TALL_ROWS * (-(-w // 16) * 16 + 8)

    stages = tall_stages(widths, *tiers)
    sizes_in = [tile(k, p) for k, _, p in stages]
    sizes_out = ([tile(widths[i + 1], pf) for i in range(1, n - 1)] + [f32(widths[n])]
                 + [tile(widths[n], pb)] + [tile(widths[i], pb) for i in range(n - 1, 1, -1)]
                 + [f32(widths[1])])
    for s in range(2 * n - 1):
        live = [(plan.in_off[s], sizes_in[s]), (plan.out_off[s], sizes_out[s])]
        if s == n - 1:  # the gram head reads h, the last trunk layer's output
            live.append((plan.out_off[n - 2], sizes_out[n - 2]))
        for at, size in live:
            assert at >= 0 and at % 16 == 0 and at + size <= plan.arena
        for i, (a, sa) in enumerate(live):
            for b, sb in live[i + 1:]:
                assert a + sa <= b or b + sb <= a, (s, live)
    # the split pass writes the gram head's input while h is live
    assert plan.in_off[n - 1] + sizes_in[n - 1] <= plan.out_off[n - 2] or (
        plan.out_off[n - 2] + sizes_out[n - 2] <= plan.in_off[n - 1])


def test_the_flagship_plan_is_the_sources():
    """The flagship's plan at (bf16x3, bf16), as the source's header gives
    it: a 163,840-byte arena (layer 1's input and output at bf16x3), five
    11,264-byte slots, 229,968 bytes in all, one CTA per SM."""
    plan = tall_plan((7, *FLAGSHIP), "bf16x3", "bf16")
    assert (plan.arena, plan.ring, plan.slot_bytes, plan.smem) == (163_840, 5, 11_264, 229_968)
    with open(os.path.join(CSRC, "fused_gram_tall.cu")) as fh:
        header = fh.read().split("#include")[0]
    for number in ("163,840", "11,264", "229,968"):
        assert number in header


@pytest.mark.parametrize("n_rows, sm_count, want", [
    (65_536, H100_SMS, "tall"), (65_536 + 37, H100_SMS, "tall"), (4096, H100_SMS, "mma"),
    (512, H100_SMS, "mma"), (256, H100_SMS, "mma"), (1, H100_SMS, "mma"),
    (65_536, None, "mma"),
])
def test_k3_batch_route_by_rows(port_model, n_rows, sm_count, want):
    """The flagship at (high, default) runs the tall kernel from the
    crossover on (65,536 rows: HMC's batch in the benchmark), and the
    16-row ``fused_gram_mma.cu`` below it (HMC at 4096 walkers, ADVI at
    512, the flow at 256) and where no card's SM count is known."""
    m, obs = port_model(FLAGSHIP)
    fn = _k3(m, obs, ("high", "default"))
    assert fn.route == "mma" and fn.tall_plan is not None
    assert k3_batch_route(fn.route, fn.tall_plan, n_rows, sm_count) == want


@pytest.mark.parametrize("sm_count", [H100_SMS, 114, 78])
def test_tall_crossover_follows_the_sm_count(port_model, sm_count):
    """The crossover is TALL_WAVES waves of 64-row tiles over the SMs of
    the card the wrapper runs on, read from the card (half a wave: the
    16-row kernel's one wave at two CTAs an SM, 4224 rows on an H100): a
    batch one row short of it keeps the 16-row kernel."""
    m, obs = port_model(FLAGSHIP)
    fn = _k3(m, obs, ("high", "default"))
    rows = tall_crossover(sm_count)
    assert rows == sm_count * TALL_ROWS * TALL_WAVES == sm_count * 2 * 16
    assert k3_batch_route(fn.route, fn.tall_plan, rows, sm_count) == "tall"
    assert k3_batch_route(fn.route, fn.tall_plan, rows - 1, sm_count) == "mma"


@pytest.mark.parametrize("case", ["members", "high-high", "default-default", "default-high",
                                  "reverse", "mixed", "f32", "too-wide", "16-wide", "skinny-only",
                                  "fan-in-12"])
def test_calls_the_tall_kernel_does_not_take_keep_their_routes(port_model, splits, case):
    """No tall plan, so every batch keeps its kernel: a member-batched
    wrapper, the bf16 pairs the kernel is not built for, the reverse and
    mixed pairs, (fp32, fp32), a network whose arena does not fit (four
    512-wide layers: two bf16x3 tiles of 512 columns are 256 KiB), a trunk
    layer 16 wide (a warpgroup would have no block), a trunk of the skinny
    layer alone, a dense first layer (the wide route); and K2 never has
    one."""
    hidden, tiers, kw, route = {
        "members": (FLAGSHIP, ("high", "default"), {"members": 2}, "mma"),
        **{f"{a}-{b}": (FLAGSHIP, (a, b), {}, "mma") for a, b in OTHER_PAIRS},
        "reverse": (FLAGSHIP, ("high", "highest"), {}, "reverse"),
        "mixed": (FLAGSHIP, ("highest", "default"), {}, "mixed"),
        "f32": (FLAGSHIP, ("highest", "highest"), {}, "f32"),
        "too-wide": ((512, 512, 512, 512), ("high", "default"), {}, "mma"),
        "16-wide": ((64, 16, 64), ("high", "default"), {}, "mma"),
        "skinny-only": ((40,), ("high", "default"), {}, "mma"),
        "fan-in-12": (FLAGSHIP, ("high", "default"), {}, "wide"),
    }[case]
    if case == "fan-in-12":
        assert fused_loglik.k3_route((12, *hidden), "bf16x3", "bf16") == route
        assert tall_plan((12, *hidden), "bf16x3", "bf16") is None
        return
    m, obs = port_model(hidden)
    if case == "members":
        stacked = tuple({k: torch.stack([v, v]) for k, v in layer.items()} for layer in m.params)
        fn = _k3(m, obs, tiers, **kw)
        fn.operands(stacked)
    else:
        fn = _k3(m, obs, tiers, **kw)
    assert fn.route == route and fn.tall_plan is None
    assert k3_batch_route(fn.route, fn.tall_plan, 1 << 20, H100_SMS) == route
    if case in ("members", "too-wide", "16-wide", "skinny-only", *(f"{a}-{b}" for a, b in
                                                                   OTHER_PAIRS)):
        assert fn.tensor_cores
    k2 = make_fused_loglik_gram(m.config, m.normalizer, obs, 25.0, precision="high",
                                device="cpu")
    assert k2.tall_plan is None


def test_tall_kernel_name_is_read_as_k3():
    """The benchmark finds K3 by its CUDA name (``port_bench/readers.py``):
    every instantiation of the tall kernel, demangled or mangled, matches
    ``KERNELS["k3"]`` and not ``KERNELS["k2"]``."""
    with open(os.path.join(CSRC, "fused_gram_tall.cu")) as fh:
        src = fh.read()
    assert re.search(r"namespace \{\nnamespace tall \{", src)
    assert re.search(r"template <int PF, int PB>\n__global__ void __launch_bounds__\([^)]*\)\n"
                     r"fused_gram_mma_kernel\(", src)
    pairs = sorted(set(re.findall(r"launch_kernel<(\d), (\d)>\(", src)))
    assert pairs == [("2", "1")]  # TALL_PAIRS: (bf16x3, bf16)
    for pf, pb in pairs:
        names = [
            f"void (anonymous namespace)::tall::fused_gram_mma_kernel<{pf}, {pb}>(float const*, "
            f"float*, float*, int, (anonymous namespace)::tall::TallNet)",
            f"_ZN51_GLOBAL__N__91d459aa_18_fused_gram_tall_cu_e40c9ba74tall21fused_gram_mma_"
            f"kernelILi{pf}ELi{pb}EEEvPKfPfS4_iNS0_7TallNetE",
        ]
        for name in names:
            assert KERNELS["k3"].search(name) and not KERNELS["k2"].search(name)
            assert not KERNELS["k1"].search(name)


def test_tall_launch_arguments(port_model):
    """The C entry's arguments after the row count: the layer count and
    widths, the pointers of w0, b0, the padded biases, u and the stream,
    zero member strides, one member, the tier codes, the plan's ints (the
    arena, the ring, each stage's input then output offsets) and the
    grid's CTAs; built once per fold and grid."""
    m, obs = port_model(FLAGSHIP)
    fn = _k3(m, obs, ("high", "default"))
    ops = fn.operands(m.params)
    args = _tall_args(ops, fn.tall_plan, H100_SMS)
    assert _tall_args(ops, fn.tall_plan, H100_SMS) is args
    n_layers, widths, ptrs, strides, members, tier, grad, plan, ctas = args
    assert n_layers == 4 and list(widths) == [7, *FLAGSHIP]
    p = ops.packed
    assert list(ptrs) == [t.data_ptr() for t in (ops.w0, ops.b0, *p.b, p.u, ops.tall)]
    assert list(strides) == [0] * 7 and members == 1
    assert (tier, grad) == (TIER_CODE["bf16x3"], TIER_CODE["bf16"])
    t = fn.tall_plan
    assert list(plan) == [t.arena, t.ring, *t.in_off, *t.out_off] and ctas == H100_SMS


def test_wrapper_counts_each_k3_call_by_route(port_model, monkeypatch):
    """A CUDA call goes through :meth:`_launch_kernel`: a batch from the
    crossover on launches the tall kernel and adds one to
    :attr:`tall_launches`, a smaller one the 16-row kernel; inside a
    recording each is counted as ``k3.route.tall`` or ``k3.route.mma``
    (the launches stubbed: the CPU has no card)."""
    m, obs = port_model(FLAGSHIP)
    fn = _k3(m, obs, ("high", "default"))
    ops = fn.operands(m.params)
    fn.sm_count = H100_SMS  # as read from an H100
    seen = []
    monkeypatch.setattr(fused_loglik, "_loglik_grad_gram_tall_cuda",
                        lambda o, x, plan, ctas: seen.append(("tall", x.shape[0], plan, ctas)))
    big = torch.zeros(tall_crossover(H100_SMS), 7)
    small = torch.zeros(4096, 7)
    with recording() as rec:
        fn._launch_kernel(lambda o, x, rows: seen.append(("mma", x.shape[0], rows)), ops, big)
        fn._launch_kernel(lambda o, x, rows: seen.append(("mma", x.shape[0], rows)), ops, small)
    assert seen == [("tall", big.shape[0], fn.tall_plan, H100_SMS), ("mma", 4096, None)]
    assert fn.tall_launches == 1
    assert rec.counters == {"k3.route.tall": 1, "k3.route.mma": 1}


def test_cpu_calls_run_the_plain_version(port_model, splits):
    """On the CPU a K3 wrapper that holds a tall plan still runs its plain
    version and launches nothing."""
    m, obs = port_model(FLAGSHIP)
    fn = _k3(m, obs, ("high", "default"))
    x = _raw(splits)
    v, g = fn(m.params, x)
    vp, gp = loglik_grad_gram_reference(fn.operands(m.params), x)
    assert torch.equal(v, vp) and torch.equal(g, gp)
    assert fn.launches == 0 and fn.tall_launches == 0
