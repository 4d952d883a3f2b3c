"""PyTorch port, the tensor-core route of flash attention (K4, K5 in
csrc/flash_attention.cu), rehearsed on the CPU in plain torch: the kernels'
rounding points and recurrences against the plain versions, and the choice of
route. The kernels themselves run only on the card (tests/test_torch_kernels.py).

The tensor-core backward rounds p and ds to bf16 as the operands of
dv = p^T dO, dq = ds k and dk = ds^T q, where the plain version (and the Pallas
kernel it mirrors) keeps them in fp32; its statistics pass carries
D_u = sum_j exp(s_j - m_run) dp_j over 64-key tiles with l's rescale, so that
D = D_u / l = rowsum(dp p). The forward rounds p relative to the running max of
the keys seen so far."""

import contextlib
import types

import numpy as np
import pytest
import torch

from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.ops import _build
from construction_clip_tpu_torch.ops import flash_attention as fa

TILE = 64   # keys a tile, as the kernels stream them
# gradients relative to the plain version's largest element (chip_smoke.py,
# tests/test_torch_kernels.py): single bf16 roundings, one step is 2^-8
GRAD_TOL_BF16 = 2e-2
FLASH_TOL_BF16 = dict(rtol=2e-2, atol=2e-2)   # the forward, as chip_smoke.py


def _inputs(shape, seed, dtype=torch.bfloat16):
    gen = np.random.default_rng(seed)
    return [torch.from_numpy(gen.standard_normal(shape).astype(np.float32)).to(dtype)
            for _ in range(4)]


def _masked(s, causal):
    if not causal:
        return s
    t = s.shape[-1]
    return torch.where(torch.ones(t, t, dtype=torch.bool).tril(), s, float("-inf"))


def _tiled_stats(s, dp, causal):
    """m, l and D = D_u / l per row, carried over 64-key tiles as the
    statistics pass carries them (s: scaled logits, dp = dO v^T, fp32)."""
    s = _masked(s, causal)
    m = torch.full(s.shape[:-1], torch.finfo(torch.float32).min)
    l, du = torch.zeros_like(m), torch.zeros_like(m)
    for j0 in range(0, s.shape[-1], TILE):
        st = s[..., j0:j0 + TILE]
        m_new = torch.maximum(m, st.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        du = du * corr + (p * dp[..., j0:j0 + TILE]).sum(dim=-1)
        m = m_new
    return m, l, du / l


def _tc_backward(q, k, v, g, causal, scale):
    """The tensor-core backward's arithmetic: fp32 s, dp and statistics, p and
    ds rounded to bf16 before their products, fp32 sums, bf16 outputs."""
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    s = qf @ kf.mT * scale
    dp = gf @ vf.mT
    m, l, dsum = _tiled_stats(s, dp, causal)
    p = torch.exp(_masked(s, causal) - m[..., None]) / l[..., None]
    ds = p * (dp - dsum[..., None]) * scale
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    return (ds16 @ kf).bfloat16(), (ds16.mT @ qf).bfloat16(), (p16.mT @ gf).bfloat16()


def _tc_forward(q, k, v, causal, scale):
    """The tensor-core forward's arithmetic: an online softmax over 64-key
    tiles, p = exp(s - m_run) rounded to bf16 for p . v, fp32 sums, o / l."""
    s = _masked(q.float() @ k.float().mT * scale, causal)
    m = torch.full(s.shape[:-1], torch.finfo(torch.float32).min)
    l = torch.zeros_like(m)
    o = torch.zeros(*s.shape[:-1], v.shape[-1])
    for j0 in range(0, s.shape[-1], TILE):
        st = s[..., j0:j0 + TILE]
        m_new = torch.maximum(m, st.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + p.bfloat16().float() @ v[..., j0:j0 + TILE, :].float()
        m = m_new
    return (o / l[..., None]).bfloat16()


def _scaled_err(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("shape, causal", [((1, 16, 257, 64), False), ((1, 12, 77, 64), True)],
                         ids=["vit_l_14", "text_causal"])
def test_bf16_operand_rounding_keeps_the_backward_within_tolerance(shape, causal):
    """(a) p and ds rounded to bf16 as operands: half of GRAD_TOL at most."""
    q, k, v, g = _inputs(shape, 8)
    scale = shape[-1] ** -0.5
    want = fa.flash_attention_bwd_plain(q, k, v, g, is_causal=causal, scale=scale)
    for name, got, w in zip(("dq", "dk", "dv"), _tc_backward(q, k, v, g, causal, scale), want):
        assert _scaled_err(got, w) <= GRAD_TOL_BF16 / 2, name


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [77, 130, 257])
def test_online_d_recurrence_equals_rowsum_dp_p(t, causal):
    """(b) D_u over 64-key tiles with l's rescale, divided by l, is rowsum(dp p)."""
    gen = np.random.default_rng(t)
    s = torch.from_numpy(gen.standard_normal((2, 3, t, t)).astype(np.float32)) * 4
    dp = torch.from_numpy(gen.standard_normal((2, 3, t, t)).astype(np.float32)) * 8
    _, _, got = _tiled_stats(s, dp, causal)
    p = torch.softmax(_masked(s, causal), dim=-1)
    want = (dp * p).sum(dim=-1)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("shape, causal", [((1, 16, 257, 64), False), ((1, 12, 77, 64), True),
                                           ((1, 2, 1024, 64), True)])
def test_running_max_rounding_keeps_the_forward_within_tolerance(shape, causal):
    """The forward's p, rounded relative to the running max, against the plain
    version's, rounded relative to the row's max."""
    q, k, v, _ = _inputs(shape, 9)
    scale = shape[-1] ** -0.5
    want = fa.flash_attention_fwd_plain(q, k, v, is_causal=causal, scale=scale)
    got = _tc_forward(q, k, v, causal, scale)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **FLASH_TOL_BF16)


@pytest.mark.parametrize("dtype, dh, want", [(torch.bfloat16, 64, "tc"),
                                             (torch.float32, 64, "simt"),
                                             (torch.bfloat16, 32, "simt"),
                                             (torch.bfloat16, 128, "simt"),
                                             (torch.float32, 32, "simt")])
def test_route(dtype, dh, want):
    """(c) bf16 at dh=64 takes the tensor-core kernels; fp32 (TF32 would break
    the fp32 tolerance) and other widths the SIMT tiles."""
    assert fa.route(dtype, dh) == want


def test_each_route_has_its_c_entries_and_counters(monkeypatch):
    """Both routes have C entries alike; on the kernel branch (a stand-in
    library on CPU tensors) each launch counts under its kernel and route."""
    for entry in ("cct_flash_attention_fwd", "cct_flash_attention_bwd"):
        assert _build.SIGNATURES[entry + "_tc"] == _build.SIGNATURES[entry]
    called = []
    lib = types.SimpleNamespace(**{name: (lambda name: lambda *a: called.append(name) or 0)(name)
                                   for name in _build.SIGNATURES})
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "on_cpu", lambda x, what: False)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    for dtype, route in ((torch.bfloat16, "tc"), (torch.float32, "simt")):
        q, k, v, g = _inputs((1, 2, 70, 64), 3, dtype)
        before = tracing.counters()
        fa.flash_attention_fwd(q, k, v, is_causal=True, scale=0.125)
        fa.flash_attention_bwd(q, k, v, g, is_causal=True, scale=0.125)
        moved = {n: c - before.get(n, 0) for n, c in tracing.counters().items()
                 if c != before.get(n, 0)}
        assert moved == {"k4": 1, f"k4.{route}": 1, "k5": 1, f"k5.{route}": 1}
        suffix = "_tc" if route == "tc" else ""
        assert called[-2:] == ["cct_flash_attention_fwd" + suffix,
                               "cct_flash_attention_bwd" + suffix]


def test_cpu_tensors_count_no_launch_on_either_route():
    q, k, v, g = _inputs((1, 2, 70, 64), 3)
    before = tracing.counters()
    fa.flash_attention_fwd(q, k, v, is_causal=True, scale=0.125)
    fa.flash_attention_bwd(q, k, v, g, is_causal=True, scale=0.125)
    assert tracing.counters() == before
