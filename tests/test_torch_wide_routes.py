"""The wide route at every K2 tier and K3 pair, on the CPU: the plans
(``tpu21cmvae_torch/ops/kernels/wide.py``) for K2's value alone and for
K3 with a tensor-core or an fp32 backward, at any width and depth, with
the workspace where shared memory does not hold them; the routing that
sends every network the dedicated kernels refuse there; and the program's
arithmetic, run op by op by ``tests/_torch_f32.py::emulate_wide``.

The emulation is held to the port's plain version on 37 rows with an
fx == 0 row, and to the JAX package's Pallas K2 and K3 (interpret mode,
as JAX's own tests run them) on the same NumPy weights, at every K2 tier
and K3 pair, on a wide network and on a deep one. On the CPU the Pallas
kernels' DEFAULT and HIGH dots run in fp32 under XLA
(``test_torch_fused_loglik.py::test_bf16_backward_passes_the_gradient_gate``),
so a bf16 or bf16x3 value tier's Pallas value is the fp32 one: a DEFAULT
forward is held to plain alone, a HIGH one to Pallas within the bf16x3
tolerance.

Tolerances: values within rtol·(|logL| + c/2) + 1e-2 nats at the value
tier's rtol (1e-5 fp32, 1e-4 bf16x3, 5e-3 bf16: ``chip_smoke.py``'s
VALUE_RTOL); gradients at an fp32 value tier under ``bench_mcmc.py``'s
gate against plain (and against Pallas at (fp32, fp32)); wherever a tier
is bf16 or bf16x3, where a summation order flips a ReLU mask or a bf16
rounding on more rows than the gate allows (the deep network: every one
of 12 × 128 units a row is a chance) and a bf16 backward's own error
grows with depth, no less accurate than plain against Pallas's fp32
gradient by the gate's margins (``grad_gate_beside``). A plan under a small
shared-memory budget (vectors spilled to the workspace) gives the
all-shared plan's results bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_f32 import emulate_wide
from _torch_pair import one_torch_thread  # noqa: F401
from test_torch_fused_loglik import port_model  # noqa: F401

from tpu21cmvae.models.direct import DirectEmulator as JaxEmulator
from tpu21cmvae.ops.loglik import make_loglik as jax_make_loglik
from tpu21cmvae.ops.loglik import make_loglik_and_grad as jax_make_loglik_and_grad
from tpu21cmvae.utils.config import DirectEmulatorConfig as JaxConfig
from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.ops.kernels import wide
from tpu21cmvae_torch.ops.kernels._common import MAX_SHARED_BYTES
from tpu21cmvae_torch.ops.kernels.fused_loglik import (
    _kernel,
    k2_route,
    k3_route,
    loglik_grad_gram_reference,
    loglik_gram_reference,
    make_fused_loglik_grad_gram,
    make_fused_loglik_gram,
    ops_plan,
    pack_wide_operands,
    WideLaunch,
)
from tpu21cmvae_torch.ops.loglik import make_loglik, make_loglik_and_grad
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig
from tpu21cmvae_torch.utils.metrics import (
    grad_gate_beside,
    grad_gate_violation,
    grad_rel_error,
)

TIERS = ("highest", "high", "default")
ROUTES = [(t, None) for t in TIERS] + [(a, b) for a in TIERS for b in TIERS]
IDS = [f"k2-{t}" for t in TIERS] + [f"k3-{a}-{b}" for a, b in ROUTES[3:]]
VALUE_RTOL = {"highest": 1e-5, "high": 1e-4, "default": 5e-3}
TIER = {"highest": "f32", "high": "bf16x3", "default": "bf16"}
PARTS = {"highest": 0, "high": 2, "default": 1}
# a wide network (a streamed middle layer) and one deeper than the
# dedicated kernels' eight layers
NETS = [(640, 520, 384), (128,) * 12]
# hidden widths of the routing test: too wide or too deep for the dedicated
# kernels at some or every tier and pair
REFUSED = [(1280,) * 3, (2048,) * 2, (4096,) * 2, (256,) * 12]


@pytest.fixture(scope="module")
def jax_pair(splits):
    """Per hidden widths: a JAX emulator, the port on its weights, an
    observation and 37 raw rows with an fx == 0 row."""
    cache = {}

    def get(hidden):
        if hidden not in cache:
            jm = JaxEmulator(splits, config=JaxConfig(hidden_dims=hidden), seed=3)
            tm = DirectEmulator.from_numpy(
                jax.tree_util.tree_map(np.asarray, jm.params),
                jax.tree_util.tree_map(np.asarray, jm.normalizer),
                config=DirectEmulatorConfig(hidden_dims=hidden), device="cpu")
            sig = jm.predict(splits.par_test[0])
            obs = (sig + np.random.default_rng(6).normal(0, 5.0, sig.shape)).astype(np.float32)
            raw = np.asarray(splits.par_test[:37], np.float32).copy()
            raw[5, 2] = 0.0
            cache[hidden] = (jm, tm, obs, raw)
        return cache[hidden]

    return get


def _wrapper(tm, obs, tiers, **kw):
    """The port's K2 (``tiers[1]`` None) or K3 wrapper on the CPU."""
    if tiers[1] is None:
        return make_fused_loglik_gram(tm.config, tm.normalizer, obs, 25.0, precision=tiers[0],
                                      device="cpu", **kw)
    return make_fused_loglik_grad_gram(tm.config, tm.normalizer, obs, 25.0, precision=tiers[0],
                                       grad_precision=tiers[1], device="cpu", **kw)


def _wide_ops(tm, obs, tiers, budget=MAX_SHARED_BYTES):
    """The wide route's operands at ``tiers`` under a shared-memory
    ``budget``, packed from the wrapper's folded operands."""
    ops = _wrapper(tm, obs, tiers).operands(tm.params)
    return pack_wide_operands(dataclasses.replace(ops, slabs=None, packed=None, program=None,
                                                  frags=None), budget)


def _pallas(jm, obs, raw, tiers):
    """JAX's Pallas K2 or K3 in interpret mode: ``(logL,)`` or ``(logL,
    dlogL/draw)`` as NumPy."""
    if tiers[1] is None:
        fn = jax_make_loglik(jm.config, jm.normalizer, obs, 25.0, backend="pallas",
                             method="gram", precision=tiers[0], block_rows=40, interpret=True)
        return (np.asarray(fn(jm.params, jnp.asarray(raw))),)
    fn = jax_make_loglik_and_grad(jm.config, jm.normalizer, obs, 25.0, backend="pallas",
                                  precision=tiers[0], grad_precision=tiers[1], block_rows=40,
                                  interpret=True)
    return tuple(np.asarray(t) for t in fn(jm.params, jnp.asarray(raw)))


def _close(got, want, c, tier):
    tol = VALUE_RTOL[tier] * (np.abs(want) + 0.5 * abs(c)) + 1e-2
    assert bool((np.abs(got - want) <= tol).all()), float((np.abs(got - want) / tol).max())


def _outputs(out):
    return tuple(t.numpy() for t in (out if isinstance(out, tuple) else (out,)))


@pytest.mark.parametrize("tiers", ROUTES, ids=IDS)
@pytest.mark.parametrize("hidden", NETS, ids=["640-520-384", "128x12"])
def test_wide_emulation_matches_plain_and_pallas(jax_pair, hidden, tiers):
    """The wide program at every K2 tier and K3 pair, emulated through its
    packed operands, against the port's plain version and JAX's Pallas
    kernel on the same weights: values within the value tier's
    tolerance (a DEFAULT forward against plain alone), gradients under the
    gate against plain at an fp32 value tier and against Pallas at (fp32,
    fp32), else beside plain against Pallas's fp32 gradient, the fx == 0
    slot exactly 0."""
    jm, tm, obs, raw = jax_pair(hidden)
    ops = _wide_ops(tm, obs, tiers)
    x = torch.as_tensor(raw)
    k3 = tiers[1] is not None
    plain = _outputs((loglik_grad_gram_reference if k3 else loglik_gram_reference)(ops, x))
    got = _outputs(emulate_wide(ops, x))
    pallas = _pallas(jm, obs, raw, tiers)
    assert all(np.isfinite(t).all() for t in got)
    _close(got[0], plain[0], float(ops.c), tiers[0])
    if tiers[0] != "default":
        _close(got[0], pallas[0], float(ops.c), tiers[0])
    if k3:
        assert got[1][5, 2] == 0.0
        if tiers[0] == "highest":
            assert grad_gate_violation(got[1], plain[1]) <= 0.0
        if tiers == ("highest", "highest"):
            assert grad_gate_violation(got[1], pallas[1]) <= 0.0
        else:  # a bf16 or bf16x3 tier against Pallas's fp32 gradient
            assert grad_gate_beside(got[1], plain[1], pallas[1]) <= 0.0


@pytest.mark.parametrize("tiers", ROUTES, ids=IDS)
def test_workspace_plan_is_the_shared_plan_bit_for_bit(jax_pair, tiers):
    """On (1200, 1300), a plan under a 120,000-byte budget spills its
    vectors to the workspace (summed n-outer, stored and loaded a chunk at
    a time) where the all-shared plan holds or streams them, and at K3 one
    a byte shorter puts the mask bits there too; the emulation of the
    programs gives the same values and gradients bit for bit: no
    placement moves a sum."""
    _, tm, obs, raw = jax_pair((1200, 1300))
    shared, spilled = _wide_ops(tm, obs, tiers), _wide_ops(tm, obs, tiers, 120_000)
    plan = ops_plan(spilled, 120_000)
    assert plan.spilled and not ops_plan(shared).spilled and plan.ws_cols > 0
    assert any(op[0] == wide.OP_LOAD for op in plan.ops)
    assert any(op[0] == wide.OP_STORE for op in plan.ops)
    assert all(wide.plan_bytes(plan, r) <= 120_000 for r in plan.heights)
    x = torch.as_tensor(raw[:9])
    want = _outputs(emulate_wide(shared, x))
    runs = [(spilled, plan)]
    if tiers[1] is not None:  # a byte short of the masks too: they go to the workspace
        budget = wide.plan_bytes(plan, 32) - 1
        runs.append((_wide_ops(tm, obs, tiers, budget), ops_plan(spilled, budget)))
        assert runs[-1][1].masks_in_ws
    for ops, its_plan in runs:
        for a, b in zip(want, _outputs(emulate_wide(ops, x, its_plan))):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("tiers", ROUTES, ids=IDS)
@pytest.mark.parametrize("hidden", REFUSED, ids=["1280x3", "2048x2", "4096x2", "256x12"])
def test_refused_networks_route_to_the_wide_route(port_model, hidden, tiers):
    """Networks the dedicated kernels refuse, by shared memory or by depth,
    build on the CPU at every K2 tier and K3 pair: the route rule
    (``k2_route``, ``k3_route``) sends them to the wide route wherever
    the dedicated kernel refuses, whose plan fits at some height and whose
    wrapper carries it; nothing is refused."""
    m, obs = port_model((32,))
    widths = (7, *hidden)
    cfg = DirectEmulatorConfig(hidden_dims=hidden)
    fn = (make_fused_loglik_gram(cfg, m.normalizer, obs, precision=tiers[0], device="cpu")
          if tiers[1] is None else
          make_fused_loglik_grad_gram(cfg, m.normalizer, obs, precision=tiers[0],
                                      grad_precision=tiers[1], device="cpu"))
    route = (k2_route(widths, TIER[tiers[0]]) if tiers[1] is None
             else k3_route(widths, TIER[tiers[0]], TIER[tiers[1]]))
    assert fn.wide == (route == "wide")
    if len(hidden) > 8 or hidden == (4096, 4096):
        assert fn.wide  # too deep, or too wide for every dedicated kernel
    if fn.wide:
        grad = None if tiers[1] is None else PARTS[tiers[1]]
        assert fn.plan == wide.wide_plan(widths, PARTS[tiers[0]], grad)
        assert fn.heights == fn.plan.heights != ()
        assert all(wide.plan_bytes(fn.plan, r) <= MAX_SHARED_BYTES for r in fn.heights)
        assert not (fn.tensor_cores or fn.mixed or fn.reverse or fn.register_tiled)


@pytest.mark.parametrize("tiers", ROUTES, ids=IDS)
def test_flagship_and_aligned_widths_keep_their_kernels(port_model, tiers):
    """The shipped flagship (288, 352, 288, 224) and ``DIRECT_ALIGNED``'s
    widths (256, 256, 128, 128, 128) stay on the dedicated kernels at
    every K2 tier and K3 pair (the routes PRs 5–18 gave them)."""
    m, obs = port_model((32,))
    for hidden in [(288, 352, 288, 224), (256, 256, 128, 128, 128)]:
        cfg = DirectEmulatorConfig(hidden_dims=hidden)
        if tiers[1] is None:
            fn = make_fused_loglik_gram(cfg, m.normalizer, obs, precision=tiers[0], device="cpu")
            assert not fn.wide and fn.tensor_cores == (tiers[0] != "highest")
            continue
        fn = make_fused_loglik_grad_gram(cfg, m.normalizer, obs, precision=tiers[0],
                                         grad_precision=tiers[1], device="cpu")
        assert not fn.wide
        a, b = TIER[tiers[0]], TIER[tiers[1]]
        want = ("f32" if a == b == "f32" else "mixed" if a == "f32" else
                "reverse" if b == "f32" else "mma")
        assert k3_route((7, *hidden), a, b) == want
        assert (fn.tensor_cores, fn.mixed, fn.reverse, fn.register_tiled) == (
            want == "mma", want == "mixed", want == "reverse", want == "f32")


@pytest.mark.parametrize("tiers", [("high", "default"), ("highest", "highest"),
                                   ("default", "high")])
def test_kernel_backend_on_a_wide_emulator_matches_pallas(jax_pair, tiers):
    """Through ``make_loglik_and_grad(backend="kernel")`` and
    ``make_loglik(method="gram", backend="kernel")`` on the CPU (the wide
    route's wrappers, their plain versions here), a (1280,)×3 emulator
    matches JAX's interpret-mode Pallas K3 and K2 on the same weights:
    values within the value tier's tolerance (a DEFAULT forward against
    plain alone), gradients under the gate at an fp32 value tier, beside
    plain at a tensor-core one."""
    jm, tm, obs, raw = jax_pair((1280,) * 3)
    x = torch.as_tensor(raw)
    valgrad = make_loglik_and_grad(tm.config, tm.normalizer, obs, 25.0, backend="kernel",
                                   precision=tiers[0], grad_precision=tiers[1])
    loglik = make_loglik(tm.config, tm.normalizer, obs, 25.0, backend="kernel", method="gram",
                         precision=tiers[0])
    widths = (7, 1280, 1280, 1280)
    assert valgrad.wide == (k3_route(widths, TIER[tiers[0]], TIER[tiers[1]]) == "wide")
    assert loglik.fused.wide == (k2_route(widths, TIER[tiers[0]]) == "wide")
    assert valgrad.wide or tiers == ("highest", "highest")
    v, g = (t.detach().numpy() for t in valgrad(tm.params, x))
    with torch.no_grad():
        v2 = loglik(tm.params, x).numpy()
    c = float(valgrad.operands(tm.params).c)
    vj, gj = _pallas(jm, obs, raw, tiers)
    (v2j,) = _pallas(jm, obs, raw, (tiers[0], None))
    _close(v2, v, c, tiers[0])
    if tiers[0] != "default":
        _close(v, vj, c, tiers[0])
        _close(v2, v2j, c, tiers[0])
    assert g[5, 2] == 0.0
    if tiers[0] == "highest":
        assert grad_gate_violation(g, gj) <= 0.0
    else:
        plain = _outputs(loglik_grad_gram_reference(valgrad.operands(tm.params), x))
        assert grad_gate_beside(g, plain[1], gj) <= 0.0


@pytest.mark.parametrize("parts,grad", [(0, 0), (2, 1), (1, 2), (0, 1), (2, None), (0, None)])
def test_wide_plans_at_any_depth_and_width(parts, grad):
    """Plans, without weights: (256,)×12 holds its vectors in shared
    memory; (4096, 4096) spills every wide vector to the workspace at
    every pair and stays within the shared budget at both heights; K2's
    value-only plan has no backward op and no masks; every OP_MM of the
    tensor-core forward or backward carries its own parts and a word
    offset inside the fragment buffer; the workspace of a CTA is its
    spilled tiles (and masks) rounded to 256 bytes, and the card's
    resident CTAs bound it."""
    deep = wide.wide_plan((7,) + (256,) * 12, parts, grad)
    assert not deep.spilled and deep.ws_cols == 0 and deep.heights
    big = wide.wide_plan((7, 4096, 4096), parts, grad)
    assert big.spilled and big.ws_cols >= 4096 and big.heights == (32, 16)
    codes = {op[0] for op in big.ops}
    assert {wide.OP_LOAD, wide.OP_STORE} <= codes
    if grad is None:
        assert big.mask_cols == 0 and not codes & {wide.OP_DX, wide.OP_DX_WRITE}
    for plan in (deep, big):
        mm = [op for op in plan.ops if op[0] == wide.OP_MM]
        allowed = {parts} | ({grad} if grad is not None else set())
        assert {op[9] for op in mm} <= allowed
        words = plan.frag_words
        for op in mm:
            if op[9]:
                assert 0 <= op[10] < words and op[11] * 16 >= op[3]
        assert plan.a_parts == max(parts, grad or 0)
    for rows in (32, 16):
        size = wide.ws_cta_bytes(big, rows)
        assert size % wide.WS_ALIGN == 0
        assert size >= 4 * {32: 32, 16: 18}[rows] * big.ws_cols
        assert wide.resident_ctas(big, rows, 132) in (132, 264)


def test_grad_gate_beside_is_the_gate_where_the_reference_is_exact():
    """``grad_gate_beside(got, ref, exact)``: the gate's excess of
    ``got`` against ``exact`` where ``ref`` is exact, and beside a
    ``ref`` with an error of its own, that error allowed on top."""
    rng = np.random.default_rng(0)
    exact = rng.normal(size=(4000, 7))
    near = exact + 1e-3 * rng.normal(size=exact.shape)
    far = exact + 5e-2 * rng.normal(size=exact.shape)
    assert grad_gate_beside(near, exact, exact) == pytest.approx(grad_gate_violation(near, exact))
    assert grad_gate_beside(far, exact, exact) > 0.0
    assert grad_gate_beside(far, far + 1e-3 * rng.normal(size=exact.shape), exact) <= 0.0
    q = np.quantile(grad_rel_error(far, exact), 0.999)
    assert q > 1e-2  # far fails the gate against exact; beside a ref as far, it passes


def test_grad_gate_beside_catches_one_faulty_row():
    """A gradient fault on one row of 65,537 (the last tile's only row)
    fails ``grad_gate_beside`` however accurate the other rows are: every
    row is counted against the exact gradient, and the fault moves that
    row by more than the reference's worst row and the gate's 0.5."""
    rng = np.random.default_rng(2)
    exact = rng.normal(size=(65_537, 7))
    ref = exact + 1e-3 * rng.normal(size=exact.shape)
    got = exact + 1e-3 * rng.normal(size=exact.shape)
    assert grad_gate_beside(got, ref, exact) <= 0.0
    got[-1] = -2.0 * exact[-1]
    assert grad_gate_beside(got, ref, exact) > 0.0


def test_wide_launch_sizes_its_grid(port_model):
    """``WideLaunch``: where the plan spills, the persistent grid's CTAs
    per member at each height are what the card holds
    (``resident_ctas``); where it does not, 0 (one CTA per row tile); no
    workspace before the first launch. A wrapper on the wide route
    launches through one on its own plan."""
    big = wide.wide_plan((7, 4096, 4096), 2, 1)
    deep = wide.wide_plan((7,) + (256,) * 12, 2, 1)
    spilled, held = WideLaunch(big, True, 132, "cpu"), WideLaunch(deep, True, 132, "cpu")
    assert spilled.spills and not held.spills
    assert [spilled.ctas(h) for h in big.heights] == [
        wide.resident_ctas(big, h, 132) for h in big.heights]
    assert [held.ctas(h) for h in deep.heights] == [0] * len(deep.heights)
    assert spilled.workspace is None and held.workspace is None
    m, obs = port_model((32,))
    fn = make_fused_loglik_grad_gram(DirectEmulatorConfig(hidden_dims=(4096, 4096)),
                                     m.normalizer, obs, precision="high",
                                     grad_precision="default", device="cpu")
    assert fn.wide_launch.plan is fn.plan and fn.wide_launch.k3


def test_wide_kernel_args_name_the_workspace(port_model):
    """A spilling plan's C arguments: the A tile's parts, the height, the
    plan's sizes, the persistent grid's CTAs and the workspace's address;
    a launch without a workspace large enough for its CTAs is refused
    before it reaches the card."""
    m, obs = port_model((32,))
    cfg = DirectEmulatorConfig(hidden_dims=(4096, 4096))
    fn = make_fused_loglik_grad_gram(cfg, m.normalizer, obs, precision="high",
                                     grad_precision="default", device="cpu")
    plan = fn.plan
    params = DirectEmulator(config=cfg, normalizer=m.normalizer, seed=1, device="cpu").params
    ops = fn.operands(params)
    assert ops.frags is not None and ops.frags.numel() == 2 * plan.frag_words
    ws = torch.empty(8 * wide.ws_cta_bytes(plan, 32), dtype=torch.uint8)
    entry, tensors, ints = _kernel(ops, True, rows=32, workspace=ws, ctas=8)
    assert entry == "k3_fused_loglik_grad_gram" and tensors[-1] is ops.frags
    assert ints == [2, 32, *plan.cols, plan.mask_cols, plan.stream_rows, len(plan.ops),
                    plan.ws_cols, int(plan.masks_in_ws), 8, ws.data_ptr()]
    with pytest.raises(ValueError, match="workspace"):
        _kernel(ops, True, rows=32, workspace=ws, ctas=9)
    with pytest.raises(ValueError, match="workspace"):
        _kernel(ops, True, rows=32)
