"""PyTorch port, the tensor-core route of the int8 fused attention block (K7),
rehearsed on the CPU: the route of every tower the int8 path quantizes, in both
dtypes, and the width rule of its int8 products; both C entries; the wrapper's
choice of entry; K7's plain version against the JAX package's Pallas int8 block
in interpret mode at the tensor-core route's head width; and, in plain torch,
the arithmetic of the new launches: the s8 GEMM's tiling (128-deep k-tiles of
four 32-deep k-steps, zeros past K, M and N) giving int8_matmul's int32
exactly, and the attention pass (tc_block_fwd) with its fp32 store against the
plain version's merged32. The kernels themselves run only on the card
(tests/test_torch_kernels.py)."""

import contextlib
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from construction_clip_tpu.ops import pallas_attention_block_int8 as jfab8
from construction_clip_tpu.ops import quant as jquant
from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.core.configs import CLIPConfig
from construction_clip_tpu_torch.models.clip import quant as quant_clip
from construction_clip_tpu_torch.ops import _build
from construction_clip_tpu_torch.ops import attention_block as fab
from construction_clip_tpu_torch.ops import attention_block_int8 as fab8
from construction_clip_tpu_torch.ops.attention import merge_heads, split_heads
from construction_clip_tpu_torch.ops.quant import (
    gemm_layout, int8_matmul, quantize_rows, quantize_tree)

TILE = 64          # rows of a query or key tile of the attention pass
S8_KTILE = 128     # int8 values of K a k-tile (a 128-byte TMA row)
S8_KSTEP = 32      # int8 values of K a wgmma k32 step
# K7's plain version against the Pallas int8 block, relative to the largest
# output (tests/test_torch_quant.py's K7_TOL): fp32 the bound the JAX package
# holds between its own two int8 paths; bf16 one bf16 step (2^-8)
PALLAS_TOL = {"float32": 2e-4, "bfloat16": 2 ** -8}
K1_TOL_BF16 = dict(rtol=2e-2, atol=2e-2)   # chip_smoke.K1_TOL: a bf16 step, either way


@pytest.fixture
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


# ---- routes ------------------------------------------------------------------

# every tower the int8 path quantizes (models/clip/quant._QUANT_PATHS: the
# image tower alone): (width, heads) and the route K7 takes in bf16
TOWERS = {"vit_b_32": (768, 12), "vit_b_16": (768, 12), "vit_l_14": (1024, 16),
          "tiny": (64, 2)}
WANT_BF16 = {"vit_b_32": "tc", "vit_b_16": "tc", "vit_l_14": "tc", "tiny": "simt"}


def test_head_width_96_keeps_the_simt_attention_pass():
    """K7's C entry takes the tensor-core pass at dh 64 alone, so its route
    keeps a head-width table of its own: dh 96 stays on the SIMT pass in
    both dtypes, though K1 and K3 take the tensor cores there in bf16."""
    assert fab8.TC_DH == (64,)
    assert fab8.route(torch.bfloat16, 96) == fab8.route(torch.float32, 96) == "simt"
    assert fab.route(torch.bfloat16, 96) == "tc"


def test_int8_path_quantizes_the_image_tower_alone():
    assert {path[0] for path in quant_clip._QUANT_PATHS} == {"vision"}
    for name, (width, heads) in TOWERS.items():
        cfg = getattr(CLIPConfig, name)()
        assert (cfg.vision.width, cfg.vision.heads) == (width, heads), name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(TOWERS))
def test_routes_on_the_int8_towers(name, dtype):
    """bf16 at dh = 64 takes the tensor-core entry, fp32 the SIMT one; at every
    tower width the int8 products run on wgmma s8."""
    width, heads = TOWERS[name]
    want = WANT_BF16[name] if dtype == torch.bfloat16 else "simt"
    assert fab8.route(dtype, width // heads) == want
    assert fab8.gemm_route(width) == "wgmma"


@pytest.mark.parametrize("d, want", [(768, "wgmma"), (1024, "wgmma"), (48, "wgmma"),
                                     (32, "wgmma"), (72, "dp4a"), (40, "dp4a"), (100, "dp4a")])
def test_int8_products_need_a_16_byte_row_pitch(d, want):
    """TMA reads the int8 rows (d bytes each) only at a pitch that is a
    multiple of 16 bytes; elsewhere the products stay on __dp4a."""
    assert fab8.gemm_route(d) == want


def test_both_entries_are_bound_alike():
    entry = "cct_attention_block_int8"
    assert _build.SIGNATURES[entry + "_tc"] == _build.SIGNATURES[entry]
    text = (_build.CSRC_DIR / "attention_block_int8.cu").read_text()
    for name in (entry, entry + "_tc"):
        assert f'extern "C" int {name}(' in text
    assert all(isinstance(n, int) for n in tracing.counters().values())


def _int8_case(gen, b, t, d, dtype):
    """x, LN params and the attention params quantized by quantize_tree, in
    the port's layout (the int8 weights K-contiguous)."""
    def arr(*shape, scale=1.0, offset=0.0):
        return torch.from_numpy(gen.standard_normal(shape).astype(np.float32) * scale + offset)

    attn = {"w_qkv": arr(d, 3 * d, scale=d ** -0.5), "b_qkv": arr(3 * d, scale=0.1).to(dtype),
            "w_out": arr(d, d, scale=d ** -0.5), "b_out": arr(d, scale=0.1).to(dtype)}
    ln = {"scale": arr(d, scale=0.1, offset=1.0).to(dtype), "bias": arr(d, scale=0.1).to(dtype)}
    return arr(b, t, d).to(dtype), ln, quantize_tree(attn, [("w_qkv",), ("w_out",)])


def _plain(x, ln, qattn, h, causal):
    return fab8.fused_attention_block_int8_plain(
        x, ln["scale"], ln["bias"], qattn["w_qkv"]["q"], qattn["w_qkv"]["s"], qattn["b_qkv"],
        qattn["w_out"]["q"], qattn["w_out"]["s"], qattn["b_out"], n_heads=h, causal=causal)


def _counted(before: dict) -> dict:
    """The counters that moved since the snapshot `before`, by how much."""
    return {k: v - before.get(k, 0) for k, v in tracing.counters().items()
            if v != before.get(k, 0)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_count_no_launch_on_either_route(dtype):
    x, ln, qattn = _int8_case(np.random.default_rng(4), 2, 9, 128, dtype)
    before = tracing.counters()
    got = fab8.fused_attention_block_int8(x, ln, qattn, n_heads=2, causal=True)
    assert torch.equal(got, _plain(x, ln, qattn, 2, True))
    assert tracing.counters() == before


@pytest.fixture
def fake_card(monkeypatch):
    """The wrapper's kernel branch on CPU tensors: a stand-in library whose C
    entries record their name and return success."""
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
                                                   (torch.bfloat16, 128, 4, ""),
                                                   (torch.bfloat16, 192, 2, ""),
                                                   (torch.float32, 128, 2, "")])
def test_wrapper_takes_its_route_entry(dtype, d, heads, want, fake_card):
    x, ln, qattn = _int8_case(np.random.default_rng(5), 2, 9, d, dtype)
    before = tracing.counters()
    fab8.fused_attention_block_int8(x, ln, qattn, n_heads=heads, causal=True)
    ((name, call),) = fake_card
    assert name == "cct_attention_block_int8" + want
    assert call[0] == _build.dtype_code(dtype) and call[-8:-3] == (2, 9, d, heads, 1)
    assert call[-2] == pytest.approx((d // heads) ** -0.5)
    assert _counted(before) == ({"k7": 1, "k7.tc": 1} if want else {"k7": 1})


# ---- the plain version against the Pallas int8 block, dh = 64 ------------------

def _jax_block(gen, d, dtype):
    """JAX-side LN params and quantized attention params (float32 draws cast
    to dtype; int8 weights from the JAX quantizer)."""
    dt = jnp.dtype(dtype)

    def arr(*shape, scale=1.0, offset=0.0):
        return jnp.asarray(gen.standard_normal(shape).astype(np.float32) * scale + offset)

    ln = {"scale": arr(d, scale=0.1, offset=1.0).astype(dt), "bias": arr(d, scale=0.1).astype(dt)}
    attn = {"w_qkv": arr(d, 3 * d, scale=d ** -0.5), "b_qkv": arr(3 * d, scale=0.1).astype(dt),
            "w_out": arr(d, d, scale=d ** -0.5), "b_out": arr(d, scale=0.1).astype(dt)}
    return ln, jquant.quantize_tree({"a": attn}, [("a", "w_qkv"), ("a", "w_out")])["a"]


def _t(a):
    return convert.to_params({"a": a}).tree()["a"].detach()


def _tree(jtree):
    tree = convert.to_params(jtree).tree()
    for key in ("w_qkv", "w_out"):   # the port keeps int8 weights K-contiguous
        if key in tree:
            tree[key] = dict(tree[key], q=gemm_layout(tree[key]["q"]))
    return tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 50, 128, 2, False), (2, 77, 128, 2, True)])
def test_plain_matches_pallas_at_the_tensor_core_head_width(shape, dtype, interpret_mode):
    """At dh = 64 (the tensor-core route's shapes: ViT-B's T = 50, and T = 77
    causal, two key tiles a head) K7's plain version tracks the Pallas int8
    block in interpret mode."""
    b, t, d, h, causal = shape
    gen = np.random.default_rng(t)
    ln, qattn = _jax_block(gen, d, dtype)
    x = jnp.asarray(gen.standard_normal((b, t, d)).astype(np.float32), dtype)
    want = _t(jfab8.fused_attention_block_int8(x, ln, qattn, n_heads=h, causal=causal)).float()
    got = _plain(_t(x), _tree(ln), _tree(qattn), h, causal)
    assert got.dtype == _t(x).dtype
    assert float((got.float() - want).abs().max()) <= PALLAS_TOL[dtype] * float(want.abs().max())


# ---- the s8 GEMM's tiling, emulated ------------------------------------------

def _s8_tiled(a, w_t, bm, bn):
    """gemm_s8's sums: [M, K] x [N, K]^T over BM x BN output tiles, each summed
    over 128-deep k-tiles in 32-deep k-steps, with zeros past M, N and K (what
    TMA reads out of bounds), in int32."""
    (m, k), n = a.shape, w_t.shape[0]
    pm, pn, pk = -m % bm, -n % bn, -k % S8_KTILE
    a = torch.nn.functional.pad(a.to(torch.int32), (0, pk, 0, pm))
    w = torch.nn.functional.pad(w_t.to(torch.int32), (0, pk, 0, pn))
    out = torch.zeros(m + pm, n + pn, dtype=torch.int32)
    for i in range(0, m + pm, bm):
        for j in range(0, n + pn, bn):
            acc = torch.zeros(bm, bn, dtype=torch.int32)
            for k0 in range(0, k + pk, S8_KTILE):
                for ks in range(k0, k0 + S8_KTILE, S8_KSTEP):
                    acc += a[i:i + bm, ks:ks + S8_KSTEP] @ w[j:j + bn, ks:ks + S8_KSTEP].T
            out[i:i + bm, j:j + bn] = acc
    return out[:m, :n]


@pytest.mark.parametrize("tile", [(128, 128), (64, 128), (64, 64)])
@pytest.mark.parametrize("m, k, n", [(50, 64, 192), (130, 160, 200), (100, 768, 96),
                                     (7, 1024, 64)])
def test_s8_tiling_gives_int8_matmul_exactly(m, k, n, tile):
    """Every tile of the rule, K below, at and past a k-tile, M and N ragged;
    the weight read as it lies (w_t = the K-contiguous weight's transpose),
    at the extremes of int8 (|sum| <= K 127^2 < 2^31)."""
    gen = np.random.default_rng(m + k + n)
    a = torch.from_numpy(gen.integers(-127, 128, (m, k), dtype=np.int8))
    a[0] = 127
    w = gemm_layout(torch.from_numpy(gen.integers(-127, 128, (k, n), dtype=np.int8)))
    w[:, 0] = 127
    assert w.mT.is_contiguous()
    got = _s8_tiled(a, w.mT, *tile)
    want = int8_matmul(a, w)
    assert want.dtype == torch.int32 and torch.equal(got, want)
    assert int(want[0, 0]) == k * 127 * 127 < 2 ** 31


def test_s8_products_leave_the_plain_version_unchanged():
    """K7's plain version with its two int8 products taken tile by tile as
    gemm_s8 sums them gives the same bits (the int32 sums are exact)."""
    x, ln, qattn = _int8_case(np.random.default_rng(6), 2, 50, 128, torch.float32)
    want = _plain(x, ln, qattn, 2, False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fab8, "int8_matmul", lambda a, w: _s8_tiled(a, w.mT, 64, 128))
        got = _plain(x, ln, qattn, 2, False)
    assert torch.equal(got, want)


# ---- the attention pass with its fp32 store, emulated ------------------------

def _causal(s, causal):
    if not causal:
        return s
    t = s.shape[-1]
    return torch.where(torch.ones(t, t, dtype=torch.bool).tril(), s, float("-inf"))


def _plain_merged32(q, k, v, causal, scale):
    """fused_attention_block_int8_plain's attention: p = exp(s - row max)
    rounded to bf16 for p . v, the fp32 sum divided by the fp32 row sum of p,
    kept in fp32."""
    s = _causal(q.float() @ k.float().mT * scale, causal)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p.bfloat16().float() @ v.float() / p.sum(dim=-1, keepdim=True)


def _tc_pass_fp32(q, k, v, causal, scale):
    """tc_block_fwd<float>'s arithmetic: base-2 logits; sweep 1 the row's max
    over 64-key tiles, sweep 2 p = 2^(t - m) per tile summed in fp32 into l,
    bf16(p) . v summed tile by tile in fp32; o / l stored in fp32."""
    c = scale * 1.4426950408889634
    t = _causal(q.float() @ k.float().mT * c, causal)
    tiles = range(0, t.shape[-1], TILE)
    m = torch.stack([t[..., j:j + TILE].amax(dim=-1) for j in tiles]).amax(dim=0)
    o = torch.zeros(*t.shape[:-1], v.shape[-1])
    l = torch.zeros(t.shape[:-1])
    for j in tiles:
        p = torch.exp2(t[..., j:j + TILE] - m[..., None])
        l = l + p.sum(dim=-1)
        o = o + p.bfloat16().float() @ v[..., j:j + TILE, :].float()
    return o / l[..., None]


@pytest.mark.parametrize("t, causal", [(50, False), (77, True), (197, False), (256, True)])
def test_fp32_store_keeps_the_plain_merged32(t, causal):
    """The pass stores merged32 unrounded: within K1's tolerance of the plain
    version's merged32 (where bf16 would lose 8 bits), and its per-row int8
    quantization (the out product's input) at most one step from the plain
    version's."""
    gen = np.random.default_rng(t + causal)
    b, h, d = 2, 3, 3 * 64
    qkv = torch.from_numpy(gen.standard_normal((b, t, 3 * d)).astype(np.float32)).bfloat16()
    q, k, v = (split_heads(z, h) for z in qkv.chunk(3, dim=-1))
    scale = 64 ** -0.5
    want = _plain_merged32(q, k, v, causal, scale)
    got = _tc_pass_fp32(q, k, v, causal, scale)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), **K1_TOL_BF16)
    assert not torch.equal(got, got.bfloat16().float())   # not rounded to bf16
    gq, _ = quantize_rows(merge_heads(got).reshape(b * t, d))
    wq, _ = quantize_rows(merge_heads(want).reshape(b * t, d))
    assert int((gq.int() - wq.int()).abs().max()) <= 1
