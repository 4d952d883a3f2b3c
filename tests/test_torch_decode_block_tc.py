"""PyTorch port, K3's tensor-core route and K2's one-pass design, rehearsed on
the CPU in plain torch. K3: the route table, both C entries, and CPU tensors
counting no launch on either route. K2: its order of operations (positions
split into chunks, one sweep of kUnroll positions per lane group at a time with
an online softmax (m, l, o), the groups of a warp merged in a fixed tree, the
warps and then the chunks (a cluster's blocks) merged in order) emulated in fp32 against the plain
version and the JAX package's t == 1 cache read
(construction_clip_tpu/models/gpt2._attn_over_cache), with and without beam
ancestry; and the chunk count. The kernels run only on the card
(tests/test_torch_kernels.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from construction_clip_tpu.models import gpt2 as jgpt2
from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.ops import _build
from construction_clip_tpu_torch.ops import attention_block as fab
from construction_clip_tpu_torch.ops import decode_attention as dec

# K2 against its plain version (chip_smoke.py's K2_TOL): rounded once at the
# output, one bf16 step apart at most; fp32 by summation order
K2_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
WARPS, UNROLL = 4, 4   # csrc/decode_attention.cu: kDecWarps, kUnroll
LAYERS, HEADS, T_MAX, DH = 2, 12, 80, 64


# ---- K3: route and entries --------------------------------------------------

@pytest.mark.parametrize("dtype, dh, want", [(torch.bfloat16, 64, "tc"),
                                             (torch.float32, 64, "simt"),
                                             (torch.bfloat16, 96, "tc"),
                                             (torch.float32, 96, "simt"),
                                             (torch.bfloat16, 32, "simt"),
                                             (torch.float32, 32, "simt")])
def test_block_backward_route(dtype, dh, want):
    assert fab.route(dtype, dh) == want


def test_block_backward_entries_are_bound_alike():
    """Both C entries are bound, with one argument list (the tensor-core one
    takes the SIMT one's arguments), and the sources define both."""
    simt = _build.SIGNATURES["cct_attention_block_bwd"]
    assert _build.SIGNATURES["cct_attention_block_bwd_tc"] == simt
    source = (_build.CSRC_DIR / "attention_block_bwd.cu").read_text()
    for name in ("cct_attention_block_bwd", "cct_attention_block_bwd_tc"):
        assert f'extern "C" int {name}(' in source


@pytest.mark.parametrize("dtype, d, heads", [(torch.bfloat16, 128, 2), (torch.float32, 128, 2),
                                             (torch.bfloat16, 64, 2)])
def test_cpu_block_backward_counts_no_launch(dtype, d, heads):
    """CPU tensors take the plain version whatever route the card would take."""
    gen = np.random.default_rng(3)

    def arr(*shape, scale=1.0):
        return torch.from_numpy(gen.standard_normal(shape).astype(np.float32) * scale).to(dtype)

    x, g = arr(2, 5, d), arr(2, 5, d)
    args = (arr(d, scale=0.1) + 1, arr(d, scale=0.1), arr(d, 3 * d, scale=d ** -0.5),
            arr(3 * d, scale=0.1), arr(d, d, scale=d ** -0.5))
    wrapper = fab.fused_attention_block_bwd
    before = tracing.counters()
    got = wrapper(x, g, *args, n_heads=heads, causal=True)
    want = fab.fused_attention_block_bwd_plain(x, g, *args, n_heads=heads, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tracing.counters() == before


# ---- K2: chunk count --------------------------------------------------------

@pytest.mark.parametrize("heads", [1, 8, 12])
def test_chunk_count_bounds(heads):
    for rows in (1, 2, 3, 7, 24, 64):
        for n_valid in (1, 2, 31, 32, 33, 64, 65, 140, 1024):
            chunks = dec.chunk_count(rows, heads, n_valid)
            assert 1 <= chunks <= min(n_valid, dec.MAX_CHUNKS)
            size = math.ceil(n_valid / chunks)   # the kernel's chunk length
            assert (chunks - 1) * size < n_valid, "an empty last chunk"
            if rows * heads >= dec.TARGET_BLOCKS:
                assert chunks == 1
            else:
                assert chunks <= math.ceil(dec.TARGET_BLOCKS / (rows * heads))


def test_chunk_count_fills_the_card_at_small_r():
    """Beam 3 of one image (36 (row, head) pairs) splits 140 positions; 24 rows
    already give a block to every SM."""
    assert dec.chunk_count(3, 12, 140) > 1
    assert dec.chunk_count(24, 12, 140) == 1


# ---- K2: order of operations ------------------------------------------------

def _merge(m, l, o, m2, l2, o2):
    """decode_attention.cu:merge, (m, l, o) and (m2, l2, o2) at the larger m."""
    mn = torch.maximum(m, m2)
    a, b = torch.exp(m - mn), torch.exp(m2 - mn)
    return mn, l * a + l2 * b, o * a[..., None] + o2 * b[..., None]


def k2_emulated(q, ck_all, cv_all, layer, cache_len, ancestry=None):
    """K2's arithmetic in fp32, in the kernel's order: for each chunk, lane
    groups sweep kUnroll positions at a time (an online softmax over each
    sweep), the groups of a warp merge in a xor tree, the warps in order, then
    the chunks in order; the output rounded once."""
    _, rows, heads, t_max, dh = ck_all.shape
    n_valid = min(cache_len + 1, t_max)
    chunks = dec.chunk_count(rows, heads, n_valid)
    lanes = 1 << math.ceil(math.log2(dh * q.element_size() / 16))   # 16 bytes a lane
    per_warp = 32 // lanes
    n_groups = WARPS * per_warp
    src = torch.arange(rows)[:, None].expand(rows, t_max)
    if ancestry is not None:
        src = ancestry.long().clamp(0, rows - 1)
    pos = torch.arange(t_max)
    k = ck_all[layer][src, :, pos[None, :]].permute(0, 2, 1, 3).float()   # [R, H, T, Dh]
    v = cv_all[layer][src, :, pos[None, :]].permute(0, 2, 1, 3).float()
    s_all = (q.float()[:, :, None, :] * dh ** -0.5 * k).sum(dim=-1)      # [R, H, T]
    neg = torch.finfo(torch.float32).min
    size = math.ceil(n_valid / chunks)
    parts = []
    for c in range(chunks):
        t0, t1 = c * size, min(n_valid, (c + 1) * size)
        m = torch.full((rows, heads, n_groups), neg)
        l = torch.zeros(rows, heads, n_groups)
        o = torch.zeros(rows, heads, n_groups, dh)
        for base in range(t0, t1, UNROLL * n_groups):
            t = base + torch.arange(UNROLL)[:, None] * n_groups + torch.arange(n_groups)
            live = t < t1                                           # [U, G]
            tc = t.clamp(max=t_max - 1)
            s = torch.where(live, s_all[:, :, tc], float("-inf"))   # [R, H, U, G]
            mx = torch.maximum(m, s.amax(dim=2))
            corr = torch.exp(m - mx)
            l, o = l * corr, o * corr[..., None]
            for u in range(UNROLL):
                p = torch.exp(s[:, :, u] - mx)
                l = l + p
                o = o + p[..., None] * torch.where(live[u][:, None], v[:, :, tc[u]], 0.0)
            m = mx
        off = 1
        while off < per_warp:   # the warp's groups, partners by xor
            perm = torch.arange(n_groups) ^ off
            m, l, o = _merge(m, l, o, m[..., perm], l[..., perm], o[..., perm, :])
            off *= 2
        cm, cl, co = m[..., 0], l[..., 0], o[..., 0, :]
        for w in range(1, WARPS):
            g = w * per_warp
            cm, cl, co = _merge(cm, cl, co, m[..., g], l[..., g], o[..., g, :])
        parts.append((cm, cl, co))
    m, l, o = parts[0]
    for part in parts[1:]:
        m, l, o = _merge(m, l, o, *part)
    return (o / l[..., None]).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_ancestry", [False, True])
@pytest.mark.parametrize("cache_len", [0, 63, 64, T_MAX - 1])
@pytest.mark.parametrize("rows", [1, 3, 24])
def test_k2_order_matches_plain_and_jax(rows, cache_len, with_ancestry, dtype):
    gen = np.random.default_rng(rows * 1000 + cache_len)
    ck = gen.standard_normal((LAYERS, rows, HEADS, T_MAX, DH)).astype(np.float32)
    cv = gen.standard_normal((LAYERS, rows, HEADS, T_MAX, DH)).astype(np.float32)
    q = gen.standard_normal((rows, HEADS, DH)).astype(np.float32)
    anc = gen.integers(0, rows, (rows, T_MAX), dtype=np.int32) if with_ancestry else None
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, ck, cv))
    tanc = None if anc is None else torch.from_numpy(anc)
    layer = 1
    got = k2_emulated(tq, tk, tv, layer, cache_len, tanc)
    plain = dec.decode_step_attention_plain(tq, tk, tv, layer, cache_len, tanc)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jgpt2._attn_over_cache(
        jnp.asarray(q).astype(jdt)[:, :, None, :], jnp.asarray(ck[layer]).astype(jdt),
        jnp.asarray(cv[layer]).astype(jdt), cache_len, None,
        None if anc is None else jnp.asarray(anc))
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), **K2_TOL[dtype])
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want[:, :, 0].astype(jnp.float32)), **K2_TOL[dtype])
