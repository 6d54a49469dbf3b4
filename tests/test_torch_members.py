"""The member axis of the port's kernels: an ensemble's M members in one
launch (``tpu21cmvae_torch/ops/kernels/_common.py``), the port of JAX's
``vmap`` over ``pallas_call``.

On the CPU a member-batched wrapper runs its ``*_members_reference``,
which reads member m's operands out of the stacked buffers at the stride
the kernel is given. Here, on three randomly initialised 7→32→48→451
members and every route of K1, K2 and K3 (the wide route,
``fused_loglik_grad_gram.cu``, on three 7→1500→48→451 members, too wide
for the others):

- the member-batched plain version equals the single-model wrapper of
  each member, bit for bit (the same fold, the same arithmetic);
- the kernels' CPU emulations (``tests/_torch_f32.py``, and the
  tensor-core emulations of ``test_torch_fused_mlp.py`` and
  ``test_torch_fused_loglik.py``) on member m's slice of the stacked
  packed operands equal the same emulation on member m's own packed
  operands, bit for bit: the stacked buffers hold each member's packing
  at its stride;
- the member-batched likelihood builders under every noise spec equal
  the single-model kernel likelihood of each member, bit for bit, and
  differentiate through the plain twin.

The kernels themselves are held to single launches on the card in
``tests/test_torch_cuda.py``.
"""

import functools

import numpy as np
import pytest
import torch
from _torch_f32 import (
    emulate_f32_grad_gram,
    emulate_f32_gram,
    emulate_f32_mlp,
    emulate_mixed_grad_gram,
    emulate_reverse_grad_gram,
    emulate_wide,
)
from _torch_pair import one_torch_thread  # noqa: F401
from test_torch_fused_loglik import _emulate_gram
from test_torch_fused_mlp import _emulate_mma

from tpu21cmvae_torch.models.direct import DirectEmulator
from tpu21cmvae_torch.models.ensemble import DeepEnsemble
from tpu21cmvae_torch.noisescale import marginalize_noise_scale
from tpu21cmvae_torch.ops.fold import fold_emulator_constants
from tpu21cmvae_torch.ops.kernels._common import (
    MAX_MEMBERS,
    member_of,
    member_strides,
    stack_members,
)
from tpu21cmvae_torch.ops.kernels.fused_loglik import (
    _kernel,
    make_fused_loglik,
    make_fused_loglik_grad_gram,
    make_fused_loglik_gram,
    pick_grad_rows,
)
from tpu21cmvae_torch.ops.kernels.fused_mlp import FusedMLP
from tpu21cmvae_torch.ops.loglik import (
    make_loglik,
    make_loglik_and_grad,
    make_member_loglik,
    make_member_loglik_and_grad,
)
from tpu21cmvae_torch.utils.config import DirectEmulatorConfig

HIDDEN = (32, 48)
# too wide for fused_gram_mma.cu's reverse mode: K3 runs the wide route,
# fused_loglik_grad_gram.cu
WIDE_HIDDEN = (1500, 48)
M = 3
NOISE_VAR = 25.0
# (kernel, value tier, backward tier): every route of K1, K2 and K3
ROUTES = [
    ("k1", "highest", None),  # fused_mlp.cu, sumsq
    ("k1", "high", None),  # fused_mlp_mma.cu at bf16x3
    ("k1", "default", None),  # fused_mlp_mma.cu at bf16
    ("k1_predict", "highest", None),  # fused_mlp.cu, the signals
    ("k1_predict", "high", None),  # fused_mlp_mma.cu, the signals
    ("k2", "highest", None),  # fused_loglik_gram.cu
    ("k2", "high", None),  # fused_gram_mma.cu
    ("k2", "default", None),
    ("k3", "highest", "highest"),  # fused_loglik_grad_gram_f32.cu
    ("k3", "high", "default"),  # fused_gram_mma.cu
    ("k3", "high", "high"),
    ("k3", "highest", "default"),  # fused_gram_mixed.cu: fp32 forward, tensor-core backward
    ("k3", "highest", "high"),
    ("k3", "high", "highest"),  # fused_gram_mma.cu with an fp32 backward, the reverse pair
    ("k3_wide", "high", "highest"),  # fused_loglik_grad_gram.cu, on WIDE_HIDDEN
]
IDS = [f"{k}-{t}-{g}" for k, t, g in ROUTES]


@pytest.fixture(scope="module")
def ens(splits):
    members = [DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=HIDDEN), seed=s,
                              device="cpu") for s in (11, 12, 13)]
    return DeepEnsemble(members)


@pytest.fixture(scope="module")
def obs(ens, splits):
    return observe(ens, splits)


def observe(ens, splits):
    sig = ens.members[0].predict(splits.par_test[0])
    return (sig + np.random.default_rng(5).normal(0, 5.0, sig.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def wide(splits):
    """Three members of hidden ``WIDE_HIDDEN`` and their observation."""
    members = [DirectEmulator(splits, config=DirectEmulatorConfig(hidden_dims=WIDE_HIDDEN),
                              seed=s, device="cpu") for s in (11, 12, 13)]
    ens = DeepEnsemble(members)
    return ens, observe(ens, splits)


@pytest.fixture
def routed(route, ens, obs, request):
    """The ensemble and observation ``route`` runs on: the wide one for
    ``k3_wide``."""
    return request.getfixturevalue("wide") if route[0] == "k3_wide" else (ens, obs)


@pytest.fixture(scope="module")
def x(splits):
    raw = np.asarray(splits.par_test[:37], np.float32).copy()  # not a tile multiple
    raw[5, 2] = 0.0  # the fx == 0 clamp
    return torch.as_tensor(raw)


def wrapper(ens, obs, route, members=None):
    """The kernel wrapper of ``route`` over ``ens``' shapes: of ``members``
    members, or of one model."""
    kernel, tier, grad = route
    cfg, norm = ens.config, ens.normalizer
    if kernel == "k1":
        return make_fused_loglik(cfg, norm, obs, NOISE_VAR, precision=tier, members=members,
                                 device="cpu")
    if kernel == "k1_predict":
        return FusedMLP(cfg.mlp().sizes, log_clamp_input=True, precision=tier, members=members,
                        fold=functools.partial(fold_emulator_constants, norm=norm),
                        device="cpu")
    if kernel == "k2":
        return make_fused_loglik_gram(cfg, norm, obs, NOISE_VAR, precision=tier,
                                      members=members, device="cpu")
    return make_fused_loglik_grad_gram(cfg, norm, obs, NOISE_VAR, precision=tier,
                                       grad_precision=grad, members=members, device="cpu")


def operands(fn, params):
    return (fn.mlp if hasattr(fn, "mlp") else fn).operands(params)


def outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("route", ROUTES, ids=IDS)
def test_member_batched_plain_equals_each_single_model(routed, x, route):
    """The member-batched wrapper on the stacked weights returns (M, B)
    values (and (M, B, 7) gradients), member m's bit for bit the
    single-model wrapper's on member m's weights."""
    ens, obs = routed
    got = outputs(wrapper(ens, obs, route, members=M)(ens.params, x))
    for m, params in enumerate(ens.member_params(ens.params)):
        want = outputs(wrapper(ens, obs, route)(params, x))
        for g, w in zip(got, want):
            assert g.shape == (M, *w.shape)
            assert torch.equal(g[m], w)


def emulation(route, ops):
    """The CPU emulation of the kernel ``route`` runs, through its packed
    operands."""
    kernel, tier, grad = route
    if kernel.startswith("k1"):
        return emulate_f32_mlp if tier == "highest" else _emulate_mma
    if ops.program is not None:  # the wide route, fused_loglik_grad_gram.cu
        return emulate_wide
    if kernel == "k2":
        return emulate_f32_gram if tier == "highest" else functools.partial(_emulate_gram,
                                                                             grad=False)
    if tier != "highest" and grad == "highest":
        return emulate_reverse_grad_gram
    if ops.slabs is not None and ops.packed is not None:
        return emulate_mixed_grad_gram
    if ops.slabs is not None:
        return emulate_f32_grad_gram
    return _emulate_gram


@pytest.mark.parametrize("route", ROUTES, ids=IDS)
def test_emulation_on_a_members_slice_equals_its_own_packing(routed, x, route):
    """The kernels' CPU emulations on member m's slice of the stacked,
    packed operands (read at its member stride) equal the same emulation
    on member m's own packed operands, bit for bit, on every route."""
    ens, obs = routed
    stacked = operands(wrapper(ens, obs, route, members=M), ens.params)
    assert stacked.members == M
    for m, params in enumerate(ens.member_params(ens.params)):
        own = operands(wrapper(ens, obs, route), params)
        mine = member_of(stacked, m)
        assert mine.members is None
        emulate = emulation(route, own)
        for g, w in zip(outputs(emulate(mine, x)), outputs(emulate(own, x))):
            assert torch.equal(g, w)


GRAM_ROUTES = [r for r in ROUTES if r[0] in ("k2", "k3", "k3_wide")]


@pytest.mark.parametrize("route", GRAM_ROUTES, ids=[f"{k}-{t}-{g}" for k, t, g in GRAM_ROUTES])
def test_member_strides_are_each_operands_member_block(routed, route):
    """Each pointer a member-batched K2 or K3 launch passes has its own
    member stride, the bytes of one member's block of that operand, and
    member 1's block there is member 1's own operand; a single model's
    strides are 0 (K1: :func:`test_k1_pointer_strides`)."""
    ens, obs = routed
    kernel, tier, grad = route
    k3 = kernel.startswith("k3")
    stacked = wrapper(ens, obs, route, members=M).operands(ens.params)
    entry, tensors, _ = _kernel(stacked, k3=k3, rows=16)
    if kernel == "k3_wide":
        assert entry == "k3_fused_loglik_grad_gram"
    strides = list(member_strides(tensors, M))
    assert list(member_strides(tensors, None)) == [0] * len(tensors)
    single = wrapper(ens, obs, route).operands(ens.member_params(ens.params)[1])
    _, own, _ = _kernel(single, k3=k3, rows=16)
    for t, s, o in zip(tensors, strides, own):
        if t is None:
            assert s == 0 and o is None
        else:
            assert s == t.stride(0) * t.element_size()
            assert torch.equal(member_of(t, 1), o)


def test_k1_pointer_strides(ens, obs):
    """K1's operands, fp32 slabs and tensor-core fragments alike: each
    member's block is contiguous and its stride is the block's bytes."""
    for tier in ("highest", "high"):
        ops = wrapper(ens, obs, ("k1", tier, None), members=M).mlp.operands(ens.params)
        tensors = ([t for pair in ops.packed for t in pair] if ops.packed is not None
                   else [ops.w[0], ops.b[0], *ops.slabs])
        assert list(member_strides(tensors, M)) == [
            t[0].numel() * t.element_size() for t in tensors]
    with pytest.raises(ValueError, match="contiguous"):
        member_strides([torch.zeros(3, 4, 5).transpose(1, 2)], 3)


def test_stack_members_round_trips_and_refuses_differences():
    """:func:`stack_members` stacks tensors, tuples and records and keeps
    what every member shares; :func:`member_of` reads member m back."""
    from tpu21cmvae_torch.ops.kernels._common import Slabs

    items = [Slabs(w=torch.full((5,), float(m)), b=torch.arange(3.0) + m) for m in range(M)]
    stacked = stack_members(items)
    assert stacked.w.shape == (M, 5)
    for m in range(M):
        assert torch.equal(member_of(stacked, m).w, items[m].w)
        assert torch.equal(member_of(stacked, m).b, items[m].b)
    assert stack_members([("f32", 1), ("f32", 1)]) == ("f32", 1)
    with pytest.raises(ValueError, match="differ"):
        stack_members(["f32", "bf16"])


@pytest.mark.parametrize("kernel", ["k1", "k2", "k3"])
def test_wrapper_refuses_a_tree_of_other_members_and_too_many(ens, obs, x, kernel):
    """A wrapper of M members refuses a single model's tree and a stacked
    tree of another member count; M beyond the grid's y limit, and 0, are
    refused when the wrapper is built."""
    route = {"k1": ("k1", "highest", None), "k2": ("k2", "high", None),
             "k3": ("k3", "high", "default")}[kernel]
    fn = wrapper(ens, obs, route, members=M)
    with pytest.raises(ValueError, match="stacked"):
        fn(ens.member_params(ens.params)[0], x)
    two = tuple({"w": layer["w"][:2], "b": layer["b"][:2]} for layer in ens.params)
    with pytest.raises(ValueError, match="stacked"):
        fn(two, x)
    for bad in (MAX_MEMBERS + 1, 0):
        with pytest.raises(ValueError, match="members"):
            wrapper(ens, obs, route, members=bad)
    assert wrapper(ens, obs, route, members=MAX_MEMBERS).members == MAX_MEMBERS


def test_grad_tile_height_counts_every_members_blocks():
    """The fp32 K3's height rule counts M·⌈B/h⌉ blocks against the SMs."""
    heights = (64, 32, 16, 8)
    assert pick_grad_rows(heights, 1024, 132) == 8  # 128 blocks of 8 rows
    assert pick_grad_rows(heights, 1024, 132, members=3) == 32  # 3 × 32 blocks
    assert pick_grad_rows(heights, 4096, 132, members=3) == 64  # over one wave: tallest
    assert pick_grad_rows(heights, 256, 132, members=3) == 8  # 3 × 32 blocks


def noise_specs(ens, obs):
    n_bins = ens.config.n_bins
    per_bin = np.random.default_rng(3).uniform(10.0, 40.0, n_bins).astype(np.float32)
    marg = ens.marginalize_foreground(25.0, n_terms=3)
    return {"scalar": NOISE_VAR, "per_bin": per_bin, "marginalized": marg,
            "scale": marginalize_noise_scale(NOISE_VAR, alpha=3.0, beta=2.0),
            "scale_marginalized": marginalize_noise_scale(marg)}


@pytest.mark.parametrize("spec", ["scalar", "per_bin", "marginalized", "scale",
                                  "scale_marginalized"])
@pytest.mark.parametrize("kind", ["direct", "gram", "grad"])
def test_member_builders_equal_each_members_kernel_likelihood(ens, obs, x, spec, kind):
    """``make_member_loglik`` (K1 direct, K2 gram) and
    ``make_member_loglik_and_grad`` (K3) under every noise spec: member m's
    rows bit for bit ``make_loglik`` / ``make_loglik_and_grad`` with
    ``backend="kernel"`` on member m alone (a noise-level wrap applies
    per member on the (M, B) values)."""
    nv = noise_specs(ens, obs)[spec]
    cfg, norm = ens.config, ens.normalizer
    if kind == "grad":
        fn = make_member_loglik_and_grad(cfg, norm, obs, nv, members=M, grad_precision="default")
        single = make_loglik_and_grad(cfg, norm, obs, nv, backend="kernel",
                                      grad_precision="default")
    else:
        fn = make_member_loglik(cfg, norm, obs, nv, members=M, method=kind)
        single = make_loglik(cfg, norm, obs, nv, backend="kernel", method=kind)
    with torch.no_grad():
        got = outputs(fn(ens.params, x))
        for m, params in enumerate(ens.member_params(ens.params)):
            for g, w in zip(got, outputs(single(params, x))):
                assert g.shape[0] == M and torch.equal(g[m], w)
    assert fn.launches == 0  # nothing launches on the CPU
    assert hasattr(fn, "replica")


def test_member_loglik_differentiates_through_its_plain_twin(ens, obs, x):
    """The member-batched value's gradient with respect to the rows and
    the stacked weights is the per-member plain likelihood's (autograd
    through the twin, as ``make_loglik(backend="kernel")``)."""
    fn = make_member_loglik(ens.config, ens.normalizer, obs, NOISE_VAR, members=M,
                            method="gram", precision="highest")
    twin = make_loglik(ens.config, ens.normalizer, obs, NOISE_VAR, method="gram",
                       precision="highest")
    params = tuple({k: v.detach().clone().requires_grad_(True) for k, v in layer.items()}
                   for layer in ens.params)
    raw = x.clone().requires_grad_(True)
    gx, gw = torch.autograd.grad(fn(params, raw).sum(), (raw, params[1]["w"]))
    raw2 = x.clone().requires_grad_(True)
    total = sum(twin(tuple({k: v[m] for k, v in layer.items()} for layer in params), raw2).sum()
                for m in range(M))
    wx, ww = torch.autograd.grad(total, (raw2, params[1]["w"]))
    torch.testing.assert_close(gx, wx, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(gw, ww, rtol=1e-5, atol=1e-4)


def test_member_builders_refuse_other_methods(ens, obs):
    with pytest.raises(ValueError, match="method"):
        make_member_loglik(ens.config, ens.normalizer, obs, NOISE_VAR, members=M, method="x")
    with pytest.raises(ValueError, match="gram"):
        make_member_loglik_and_grad(ens.config, ens.normalizer, obs, NOISE_VAR, members=M,
                                    method="direct")
