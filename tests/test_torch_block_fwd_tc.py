"""PyTorch port, the tensor-core routes of the fused block's forward (K1) and of
the fused MLP residual (K9), rehearsed on the CPU: the route tables on every
(dtype, width) the port's configurations reach (towers and ClipCap's
transformer mappers), both C entries of each kernel,
the wrappers' choice of entry, the plain versions against the JAX package's
Pallas kernels in interpret mode at the text tower's T = 77 causal shape, and
the arithmetic of K1's attention pass (p rounded relative to the row's max,
not the running max that K4 uses) in plain torch, at head width 64 and at 96
(a head as three 32-column panels, GPT-2's transformer mapper). The kernels themselves run
only on the card (tests/test_torch_kernels.py)."""

import contextlib
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from construction_clip_tpu.ops import pallas_attention_block as jfab
from construction_clip_tpu.ops import pallas_mlp as jmlp
from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.core.configs import CLIPConfig, GPT2Config, T5Config
from construction_clip_tpu_torch.models.clipcap.model import MAPPER_HEADS
from construction_clip_tpu_torch.models.clipcap.t5_model import mapper_shape
from construction_clip_tpu_torch.ops import _build
from construction_clip_tpu_torch.ops import attention_block as fab
from construction_clip_tpu_torch.ops import mlp
from construction_clip_tpu_torch.ops.attention import merge_heads, split_heads

TILE = 64   # keys a tile, as the kernel stages them
PANEL = 32  # columns of a dh-96 head's TMA box (csrc/attention_tc.cuh: HeadTile<96>)
KSTEP = 16  # the reduction of one wgmma k-step
# fp32 on both sides, sums in another order (tests/test_torch_attention_block.py)
FP32_TOL = dict(rtol=3e-5, atol=3e-5)
K1_TOL_BF16 = dict(rtol=2e-2, atol=2e-2)   # chip_smoke.K1_TOL


@pytest.fixture
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


# ---- routes ------------------------------------------------------------------

# every tower of the port's configurations: (width, heads), and the route each
# dtype takes for K1 (by head width) and K9 (by width and hidden = 4 width)
TOWERS = {"vit_b_32 image": (768, 12), "vit_b_32 text": (512, 8),
          "vit_b_16 image": (768, 12), "vit_l_14 image": (1024, 16),
          "vit_l_14 text": (768, 12), "tiny image": (64, 2), "tiny text": (32, 2)}
WANT_BF16 = {"vit_b_32 image": ("tc", "tc"), "vit_b_32 text": ("tc", "tc"),
             "vit_b_16 image": ("tc", "tc"), "vit_l_14 image": ("tc", "tc"),
             "vit_l_14 text": ("tc", "tc"), "tiny image": ("simt", "tc"),
             "tiny text": ("simt", "tc")}


def test_towers_are_the_configurations():
    def tower(cfg, name):
        part = cfg.vision if name.endswith("image") else cfg.text
        return part.width, part.heads

    for name in TOWERS:
        cfg = getattr(CLIPConfig, name.split()[0])()
        assert tower(cfg, name) == TOWERS[name], name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(TOWERS))
def test_routes_on_the_port_configurations(name, dtype):
    width, heads = TOWERS[name]
    want = WANT_BF16[name] if dtype == torch.bfloat16 else ("simt", "simt")
    assert (fab.route(dtype, width // heads), mlp.route(dtype, width, 4 * width)) == want


# ClipCap's transformer mappers (width n_embd in MAPPER_HEADS heads): GPT-2's
# 8 heads of 96 and mT5's 8 of 64. Their ReLU blocks never take K9, so only
# K1's (and K3's) route is theirs: the tensor cores in bf16, SIMT in fp32.
MAPPERS = {"gpt2 mapper": (768, 8), "mt5 mapper": (512, 8)}


def test_mappers_are_the_configurations():
    assert MAPPERS["gpt2 mapper"] == (GPT2Config().n_embd, MAPPER_HEADS)
    assert MAPPERS["mt5 mapper"] == (mapper_shape(T5Config()).n_embd, MAPPER_HEADS)


@pytest.mark.parametrize("dtype, want", [(torch.bfloat16, "tc"), (torch.float32, "simt")])
@pytest.mark.parametrize("name", sorted(MAPPERS))
def test_routes_on_the_mapper_configurations(name, dtype, want):
    width, heads = MAPPERS[name]
    assert fab.route(dtype, width // heads) == want


@pytest.mark.parametrize("dtype, d, hidden, want", [(torch.bfloat16, 40, 104, "tc"),
                                                    (torch.bfloat16, 40, 100, "simt"),
                                                    (torch.bfloat16, 44, 176, "simt"),
                                                    (torch.float32, 768, 3072, "simt")])
def test_mlp_route_needs_a_16_byte_row_pitch(dtype, d, hidden, want):
    assert mlp.route(dtype, d, hidden) == want


def test_tensor_core_entries_are_bound_alike():
    """Each tensor-core entry takes its SIMT entry's arguments, and the
    sources define both."""
    for entry, source in (("cct_attention_block_fwd", "attention_block.cu"),
                          ("cct_mlp_residual", "mlp_residual.cu")):
        assert _build.SIGNATURES[entry + "_tc"] == _build.SIGNATURES[entry]
        text = (_build.CSRC_DIR / source).read_text()
        for name in (entry, entry + "_tc"):
            assert f'extern "C" int {name}(' in text
    assert all(isinstance(n, int) for n in tracing.counters().values())


def _block_args(gen, b, t, d, dtype):
    def arr(*shape, scale=1.0, offset=0.0):
        a = gen.standard_normal(shape).astype(np.float32) * scale + offset
        return torch.from_numpy(a).to(dtype)

    return arr(b, t, d), (arr(d, scale=0.1, offset=1.0), arr(d, scale=0.1),
                          arr(d, 3 * d, scale=d ** -0.5), arr(3 * d, scale=0.1),
                          arr(d, d, scale=d ** -0.5), arr(d, scale=0.1))


def _mlp_args(gen, b, t, d, hidden, dtype):
    def arr(*shape, scale=1.0, offset=0.0):
        a = gen.standard_normal(shape).astype(np.float32) * scale + offset
        return torch.from_numpy(a).to(dtype)

    return arr(b, t, d), (arr(d, scale=0.1, offset=1.0), arr(d, scale=0.1),
                          arr(d, hidden, scale=d ** -0.5), arr(hidden, scale=0.1),
                          arr(hidden, d, scale=hidden ** -0.5), arr(d, scale=0.1))


def _counted(before: dict) -> dict:
    """The counters that moved since the snapshot `before`, by how much."""
    return {k: v - before.get(k, 0) for k, v in tracing.counters().items()
            if v != before.get(k, 0)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_count_no_launch_on_either_route(dtype):
    gen = np.random.default_rng(4)
    x, args = _block_args(gen, 2, 9, 128, dtype)
    before = tracing.counters()
    got = fab.fused_attention_block_fwd(x, *args, n_heads=2, causal=True)
    assert torch.equal(got, fab.fused_attention_block_plain(x, *args, n_heads=2, causal=True))
    assert tracing.counters() == before
    x, args = _mlp_args(gen, 2, 9, 64, 256, dtype)
    assert torch.equal(mlp.fused_mlp_residual_fwd(x, *args), mlp.fused_mlp_residual_plain(x, *args))
    assert tracing.counters() == before


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' kernel branch on CPU tensors: a stand-in library whose C
    entries record their name and return success, so that the choice of
    entry and the counters can be checked without a card."""
    called = []

    def entry(name):
        def run(*args):
            called.append((name, args))
            return 0
        return run

    lib = types.SimpleNamespace(**{name: entry(name) for name in _build.SIGNATURES})
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "on_cpu", lambda x, what: False)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return called


@pytest.mark.parametrize("dtype, d, heads, want", [(torch.bfloat16, 128, 2, "_tc"),
                                                   (torch.bfloat16, 192, 2, "_tc"),
                                                   (torch.bfloat16, 128, 4, ""),
                                                   (torch.float32, 128, 2, ""),
                                                   (torch.float32, 192, 2, "")])
def test_block_wrapper_takes_its_route_entry(dtype, d, heads, want, fake_card):
    x, args = _block_args(np.random.default_rng(5), 2, 9, d, dtype)
    before = tracing.counters()
    fab.fused_attention_block_fwd(x, *args, n_heads=heads, causal=True)
    ((name, call),) = fake_card
    assert name == "cct_attention_block_fwd" + want
    assert call[0] == _build.dtype_code(dtype) and call[-8:-3] == (2, 9, d, heads, 1)
    assert _counted(before) == ({"k1": 1, "k1.tc": 1} if want else {"k1": 1})


@pytest.mark.parametrize("dtype, d, heads, want", [(torch.bfloat16, 128, 2, "_tc"),
                                                   (torch.bfloat16, 192, 2, "_tc"),
                                                   (torch.bfloat16, 128, 4, ""),
                                                   (torch.float32, 128, 2, ""),
                                                   (torch.float32, 192, 2, "")])
def test_block_backward_wrapper_takes_its_route_entry(dtype, d, heads, want, fake_card):
    """K3's wrapper: the route's C entry (beside the workspace query), the
    larger T-typed workspace of the tensor-core route and of fp32, and h
    handed back from it."""
    x, args = _block_args(np.random.default_rng(7), 2, 9, d, dtype)
    g = x.flip(1).contiguous()
    wrapper = fab.fused_attention_block_bwd
    before = tracing.counters()
    got = wrapper(x, g, *args[:5], n_heads=heads, causal=True, with_h=True)
    ((name, call),) = [c for c in fake_card if not c[0].endswith("_work_floats")]
    assert name == "cct_attention_block_bwd" + want
    assert call[0] == _build.dtype_code(dtype) and call[-8:-3] == (2, 9, d, heads, 1)
    assert call[-2] == pytest.approx((d // heads) ** -0.5)
    assert _counted(before) == ({"k3": 1, "k3.tc": 1} if want else {"k3": 1})
    assert (got[5] is not None) == (bool(want) or dtype == torch.float32)


@pytest.mark.parametrize("dtype, d, hidden, want", [(torch.bfloat16, 64, 256, "_tc"),
                                                    (torch.bfloat16, 64, 100, ""),
                                                    (torch.float32, 64, 256, "")])
def test_mlp_wrapper_takes_its_route_entry(dtype, d, hidden, want, fake_card):
    x, args = _mlp_args(np.random.default_rng(6), 2, 9, d, hidden, dtype)
    before = tracing.counters()
    mlp.fused_mlp_residual_fwd(x, *args)
    ((name, call),) = fake_card
    assert name == "cct_mlp_residual" + want
    assert call[0] == _build.dtype_code(dtype) and call[-5:-2] == (18, d, hidden)
    assert _counted(before) == ({"k9": 1, "k9.tc": 1} if want else {"k9": 1})


# ---- the plain versions against the Pallas kernels at T = 77, causal ---------

def _ulp_steps(got, want):
    """|got - want| in bf16 steps at want's magnitude."""
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    return np.abs(got - want) / step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_plain_matches_pallas_at_the_text_tower_shape(dtype, interpret_mode):
    """The text towers' [B, 77, D] causal block (two key tiles a head, where
    K4's running-max rounding would part from the Pallas kernel's): the plain
    version against the Pallas block in interpret mode, fp32 to summation
    order, bf16 evaluated op by op (jax.disable_jit) to one bf16 step."""
    gen = np.random.default_rng(77)
    x, args = _block_args(gen, 2, 77, 128, torch.float32)
    jdt = getattr(jnp, dtype)
    jx, jargs = jnp.asarray(x.numpy()).astype(jdt), [jnp.asarray(a.numpy()).astype(jdt)
                                                     for a in args]
    ln = {"scale": jargs[0], "bias": jargs[1]}
    attn = dict(zip(("w_qkv", "b_qkv", "w_out", "b_out"), jargs[2:]))
    tdt = getattr(torch, dtype)
    got = fab.fused_attention_block_plain(x.to(tdt), *(a.to(tdt) for a in args), n_heads=2,
                                          causal=True).float().numpy()
    if dtype == "float32":
        want = jfab.fused_attention_block(jx, ln, attn, n_heads=2, causal=True)
        np.testing.assert_allclose(got, np.asarray(want), **FP32_TOL)
        return
    with jax.disable_jit():
        want = np.asarray(jfab.fused_attention_block(jx, ln, attn, n_heads=2, causal=True)
                          .astype(jnp.float32))
    steps = _ulp_steps(got, want)
    assert np.all(steps <= 1), float(steps.max())
    assert np.mean(got == want) > 0.99


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_plain_matches_pallas_at_the_text_tower_shape(dtype, interpret_mode):
    gen = np.random.default_rng(78)
    x, args = _mlp_args(gen, 2, 77, 64, 256, torch.float32)
    jdt = getattr(jnp, dtype)
    jx, (s, b, wf, bf, wp, bp) = (jnp.asarray(x.numpy()).astype(jdt),
                                  [jnp.asarray(a.numpy()).astype(jdt) for a in args])
    tdt = getattr(torch, dtype)
    got = mlp.fused_mlp_residual_plain(x.to(tdt), *(a.to(tdt) for a in args)).float().numpy()

    def call():
        return jmlp.fused_mlp_residual(jx, {"w_fc": wf, "b_fc": bf, "w_proj": wp, "b_proj": bp},
                                       {"scale": s, "bias": b}).astype(jnp.float32)

    if dtype == "float32":
        np.testing.assert_allclose(got, np.asarray(call()), rtol=2e-5, atol=2e-5)
        return
    with jax.disable_jit():
        want = np.asarray(call())
    steps = _ulp_steps(got, want)
    assert np.all(steps <= 1), float(steps.max())
    assert np.mean(got == want) > 0.99


# ---- K1's attention pass, emulated -------------------------------------------

def _heads(gen, b, h, t, dh):
    return [torch.from_numpy(gen.standard_normal((b, h, t, dh)).astype(np.float32)).bfloat16()
            for _ in range(3)]


def _causal(s, causal):
    if not causal:
        return s
    t = s.shape[-1]
    return torch.where(torch.ones(t, t, dtype=torch.bool).tril(), s, float("-inf"))


def _plain_merged(q, k, v, causal, scale):
    """fused_attention_block_plain's attention: p = exp(s - row max) rounded
    to bf16 for p . v, the fp32 sum divided by the fp32 row sum of p."""
    s = _causal(q.float() @ k.float().mT * scale, causal)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return (p.bfloat16().float() @ v.float() / p.sum(dim=-1, keepdim=True)).bfloat16(), p


def _tc_pass(q, k, v, causal, scale):
    """tc_block_fwd's arithmetic: base-2 logits t = s scale log2(e); sweep 1
    the row's max over 64-key tiles, sweep 2 p = 2^(t - m) per tile, summed in
    fp32 into l, bf16(p) . v summed tile by tile in fp32; o / l rounded once."""
    c = scale * 1.4426950408889634
    t = _causal(q.float() @ k.float().mT * c, causal)
    tiles = range(0, t.shape[-1], TILE)
    m = torch.stack([t[..., j:j + TILE].amax(dim=-1) for j in tiles]).amax(dim=0)
    o = torch.zeros(*t.shape[:-1], v.shape[-1])
    l = torch.zeros(t.shape[:-1])
    ps = []
    for j in tiles:
        p = torch.exp2(t[..., j:j + TILE] - m[..., None])
        l = l + p.sum(dim=-1)
        o = o + p.bfloat16().float() @ v[..., j:j + TILE, :].float()
        ps.append(p)
    return (o / l[..., None]).bfloat16(), torch.cat(ps, dim=-1)


def _running_max_p(q, k, causal, scale):
    """K4's p: exp(s - m) relative to the max of the key tiles seen so far."""
    s = _causal(q.float() @ k.float().mT * scale, causal)
    m = torch.full(s.shape[:-1], torch.finfo(torch.float32).min)
    ps = []
    for j in range(0, s.shape[-1], TILE):
        m = torch.maximum(m, s[..., j:j + TILE].amax(dim=-1))
        ps.append(torch.exp(s[..., j:j + TILE] - m[..., None]))
    return torch.cat(ps, dim=-1)


@pytest.mark.parametrize("t, causal", [(50, False), (77, True), (77, False), (256, True)])
def test_row_max_pass_keeps_the_plain_rounding_points(t, causal):
    """The pass's bf16(p) is the plain version's bf16(p) (base-2 exponent
    aside), and its merged heads are within K1's bf16 tolerance."""
    q, k, v = _heads(np.random.default_rng(t + causal), 2, 3, t, 64)
    scale = 64 ** -0.5
    want, p_plain = _plain_merged(q, k, v, causal, scale)
    got, p_pass = _tc_pass(q, k, v, causal, scale)
    assert torch.mean((p_pass.bfloat16() == p_plain.bfloat16()).float()) > 0.99
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **K1_TOL_BF16)


def test_running_max_rounds_p_elsewhere_at_t77():
    """Why K1 needs a pass of its own: at T = 77 causal, rows past the first
    key tile see a larger max in the second tile, so K4's running-max p of the
    first tile is a different bf16 number from the row-max p there."""
    q, k, _ = _heads(np.random.default_rng(9), 2, 3, 77, 64)
    scale = 64 ** -0.5
    row_max = _plain_merged(q, k, k, True, scale)[1]
    running = _running_max_p(q, k, True, scale)
    assert not torch.equal(running.bfloat16(), row_max.bfloat16())
    assert torch.equal(running[..., :TILE, :].bfloat16(), row_max[..., :TILE, :].bfloat16())


# ---- K1's attention pass at head width 96, emulated ---------------------------

def _panel_logits(q, k):
    """q k^T over a dh-96 head as tc_block_fwd<bf16, 96> sums it in fp32: six
    16-column k-steps, two in each of the head's three 32-column panels."""
    assert q.shape[-1] % PANEL == 0
    s = torch.zeros(*q.shape[:-1], k.shape[-2])
    for c in range(0, q.shape[-1], KSTEP):
        s = s + q[..., c:c + KSTEP].float() @ k[..., c:c + KSTEP].float().mT
    return s


def _tc_pass_dh96(q, k, v, causal, scale):
    """tc_block_fwd<bf16, 96>'s arithmetic: per 64-row query tile the 64-key
    tiles up to the diagonal (causal) or all; sweep 1 the row's max of the
    base-2 logits, sweep 2 p = 2^(t - m) summed in fp32 into l and bf16(p) . v
    over 16-key k-steps, each one 96-column product across the three panels;
    o / l rounded once. -> merged heads, p."""
    c = scale * 1.4426950408889634
    t_len = q.shape[-2]
    merged = torch.zeros(q.shape, dtype=torch.bfloat16)
    p_all = torch.zeros(*q.shape[:-1], t_len)
    for q0 in range(0, t_len, TILE):
        q_tile, rows = q[..., q0:q0 + TILE, :], torch.arange(q0, min(t_len, q0 + TILE))
        keys = range(0, min(t_len, q0 + TILE) if causal else t_len, TILE)

        def logits(j):
            t = _panel_logits(q_tile, k[..., j:j + TILE, :]) * c
            if causal:
                cols = torch.arange(j, min(t_len, j + TILE))
                t = torch.where(cols[None, :] <= rows[:, None], t, float("-inf"))
            return t

        m = torch.stack([logits(j).amax(dim=-1) for j in keys]).amax(dim=0)
        o = torch.zeros(*q_tile.shape)
        l = torch.zeros(q_tile.shape[:-1])
        for j in keys:
            p = torch.exp2(logits(j) - m[..., None])
            l = l + p.sum(dim=-1)
            p_lo, v_tile = p.bfloat16().float(), v[..., j:j + TILE, :].float()
            for r in range(0, p_lo.shape[-1], KSTEP):
                o = o + p_lo[..., r:r + KSTEP] @ v_tile[..., r:r + KSTEP, :]
            p_all[..., q0:q0 + TILE, j:j + TILE] = p
        merged[..., q0:q0 + TILE, :] = (o / l[..., None]).bfloat16()
    return merged, p_all


def _block_through_the_pass(x, args, n_heads, causal):
    """K1's tensor-core chain in plain torch with the dh-96 pass: h = T(LN(x)),
    qkv = T(T(h W_qkv) + b_qkv), the pass, out = T(x + merged W_out + b_out)."""
    ln_s, ln_b, w_qkv, b_qkv, w_out, b_out = args
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    h = ((x32 - mean) * torch.rsqrt(var + 1e-5) * ln_s.float() + ln_b.float()).to(x.dtype)
    qkv = (h.float() @ w_qkv.float()).to(x.dtype) + b_qkv
    q, k, v = (split_heads(z, n_heads) for z in qkv.chunk(3, dim=-1))
    merged, _ = _tc_pass_dh96(q, k, v, causal, (x.shape[-1] // n_heads) ** -0.5)
    y = merge_heads(merged).float() @ w_out.float()
    return (x32 + y + b_out.float()).to(x.dtype)


@pytest.mark.parametrize("t, causal", [(30, False), (30, True), (65, False), (65, True)])
def test_dh96_pass_keeps_the_plain_rounding_points(t, causal, interpret_mode):
    """At 2 heads of 96 (T = 30: one tile, the mapper's rows; 65: one row in
    a second tile): the panel-wise q k^T is the head's product, the pass's
    bf16(p) the plain version's, its merged heads within K1's bf16 tolerance,
    and the whole block through it within that tolerance of both the plain
    version and the Pallas block in interpret mode."""
    gen = np.random.default_rng(960 + t + causal)
    q, k, v = _heads(gen, 2, 2, t, 96)
    np.testing.assert_allclose(_panel_logits(q, k).numpy(), (q.float() @ k.float().mT).numpy(),
                               rtol=1e-5, atol=1e-4)
    scale = 96 ** -0.5
    want, p_plain = _plain_merged(q, k, v, causal, scale)
    got, p_pass = _tc_pass_dh96(q, k, v, causal, scale)
    assert torch.mean((p_pass.bfloat16() == p_plain.bfloat16()).float()) > 0.99
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **K1_TOL_BF16)

    x, args = _block_args(gen, 2, t, 192, torch.bfloat16)
    block = _block_through_the_pass(x, args, 2, causal).float().numpy()
    plain = fab.fused_attention_block_plain(x, *args, n_heads=2, causal=causal)
    np.testing.assert_allclose(block, plain.float().numpy(), **K1_TOL_BF16)
    jx, jargs = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                 [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in args])
    pallas = jfab.fused_attention_block(jx, {"scale": jargs[0], "bias": jargs[1]},
                                        dict(zip(("w_qkv", "b_qkv", "w_out", "b_out"), jargs[2:])),
                                        n_heads=2, causal=causal)
    np.testing.assert_allclose(block, np.asarray(pallas.astype(jnp.float32)), **K1_TOL_BF16)
