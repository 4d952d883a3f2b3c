"""PyTorch port, the CUDA kernels and their build module. This file imports no JAX, so
it also runs on a machine that has a GPU and no JAX:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

The tests marked `cuda` hold each kernel against its plain version on the card
and skip where there is none (a CUDA kernel has no CPU mode); the others check
the build module and the wrappers' dispatch on the CPU."""

import contextlib
import os
import shutil
import threading
import time
import types

import numpy as np
import pytest
import torch

from construction_clip_tpu_torch.ops import _build
from construction_clip_tpu_torch.ops import attention_block as fab
from construction_clip_tpu_torch.ops import attention_block_int8 as fab8
from construction_clip_tpu_torch.ops import collectives as coll
from construction_clip_tpu_torch.ops import decode_attention as dec
from construction_clip_tpu_torch.ops import flash_attention as fa
from construction_clip_tpu_torch.ops import mlp
from construction_clip_tpu_torch.ops import preprocess as norm
from construction_clip_tpu_torch.ops import vocab_head as vh


@pytest.fixture
def gen():
    return np.random.default_rng(1234)


def test_nvcc_command_targets_hopper():
    """One nvcc per source, each into its own library named by its hash."""
    sources = set()
    for src in _build.sources():
        cmd = _build.nvcc_command("nvcc", _build.library_path(src), src)
        assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd and "-O3" in cmd
        sources |= {os.path.basename(c) for c in cmd if c.endswith(".cu")}
        assert _build.library_path(src).name.startswith(f"libcct_{src.stem}_")
    assert sources == {"all_gather.cu", "attention_block.cu", "attention_block_bwd.cu",
                       "attention_block_int8.cu", "decode_attention.cu", "flash_attention.cu",
                       "mlp_residual.cu", "normalize_u8.cu", "vocab_head.cu"}
    assert _build.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")


def test_source_hash_follows_the_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = _build.source_hash()
    assert before == _build.source_hash()
    (csrc / "common.cuh").write_text((csrc / "common.cuh").read_text() + "\n// edit\n")
    assert _build.source_hash() != before


def test_missing_nvcc_is_an_error(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()


def test_kernels_take_fp32_and_bf16_only():
    assert _build.dtype_code(torch.float32) == 0 and _build.dtype_code(torch.bfloat16) == 1
    with pytest.raises(ValueError):
        _build.dtype_code(torch.float16)


def test_cpu_tensors_take_the_plain_version(gen):
    """On CPU tensors each wrapper returns its plain version's result and
    counts no launch."""
    x = torch.from_numpy(gen.standard_normal((2, 5, 16)).astype(np.float32))
    ln = {"scale": torch.ones(16), "bias": torch.zeros(16)}
    attn = {"w_qkv": torch.from_numpy(gen.standard_normal((16, 48)).astype(np.float32)),
            "b_qkv": torch.zeros(48),
            "w_out": torch.from_numpy(gen.standard_normal((16, 16)).astype(np.float32)),
            "b_out": torch.zeros(16)}
    before = fab.fused_attention_block.launches
    got = fab.fused_attention_block(x, ln, attn, n_heads=2, causal=True)
    want = fab.fused_attention_block_plain(x, ln["scale"], ln["bias"], *attn.values(),
                                           n_heads=2, causal=True)
    assert torch.equal(got, want) and fab.fused_attention_block.launches == before

    ck = torch.from_numpy(gen.standard_normal((2, 3, 2, 6, 8)).astype(np.float32))
    q = torch.from_numpy(gen.standard_normal((3, 2, 8)).astype(np.float32))
    before = dec.decode_step_attention.launches
    got = dec.decode_step_attention(q, ck, ck, 1, 4)
    assert torch.equal(got, dec.decode_step_attention_plain(q, ck, ck, 1, 4))
    assert dec.decode_step_attention.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


# kernel vs plain version on the card, same inputs: fp32 differs by summation
# order only; bf16 by at most a couple of bf16 rounding steps (2^-7 relative)
CARD_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 50, 768, 12, False), (9, 77, 512, 8, True),
                                   (36, 50, 768, 12, False), (36, 77, 512, 8, True),
                                   (9, 77, 768, 12, True)])
def test_attention_block_kernel_on_card(shape, dtype, gen, cuda_device):
    b, t, d, h, causal = shape

    def arr(*s, scale=1.0, offset=0.0):
        a = gen.standard_normal(s).astype(np.float32) * scale + offset
        return torch.from_numpy(a).to(cuda_device, dtype)

    x = arr(b, t, d)
    ln = {"scale": arr(d, scale=0.1, offset=1.0), "bias": arr(d, scale=0.1)}
    attn = {"w_qkv": arr(d, 3 * d, scale=d ** -0.5), "b_qkv": arr(3 * d, scale=0.1),
            "w_out": arr(d, d, scale=d ** -0.5), "b_out": arr(d, scale=0.1)}
    before = fab.fused_attention_block.launches
    got = fab.fused_attention_block(x, ln, attn, n_heads=h, causal=causal)
    want = fab.fused_attention_block_plain(x, ln["scale"], ln["bias"], *attn.values(),
                                           n_heads=h, causal=causal)
    torch.cuda.synchronize()
    assert fab.fused_attention_block.launches == before + 1
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **CARD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_ancestry", [False, True])
def test_decode_attention_kernel_on_card(with_ancestry, dtype, gen, cuda_device):
    layers, rows, heads, t_max, dh = 12, 24, 12, 140, 64
    ck, cv = (torch.from_numpy(gen.standard_normal((layers, rows, heads, t_max, dh))
                               .astype(np.float32)).to(cuda_device, dtype) for _ in range(2))
    q = torch.from_numpy(gen.standard_normal((rows, heads, dh)).astype(np.float32)).to(
        cuda_device, dtype)
    anc = torch.from_numpy(gen.integers(0, rows, (rows, t_max), dtype=np.int32)).to(cuda_device)
    ancestry = anc if with_ancestry else None
    before = dec.decode_step_attention.launches
    got = dec.decode_step_attention(q, ck, cv, 5, 90, ancestry)
    want = dec.decode_step_attention_plain(q, ck, cv, 5, 90, ancestry)
    torch.cuda.synchronize()
    assert dec.decode_step_attention.launches == before + 1
    # one rounding to the output dtype in both versions
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)
    with pytest.raises(NotImplementedError):
        dec.decode_step_attention(q, ck, cv, 5, 90, ancestry,
                                  attn_bias=torch.zeros(rows, 1, 1, t_max, device=cuda_device))


def _block_case(gen, dev, dtype, b, t, d):
    def arr(*s, scale=1.0, offset=0.0):
        a = gen.standard_normal(s).astype(np.float32) * scale + offset
        return torch.from_numpy(a).to(dev, dtype)

    x, g = arr(b, t, d), arr(b, t, d)
    args = (arr(d, scale=0.1, offset=1.0), arr(d, scale=0.1), arr(d, 3 * d, scale=d ** -0.5),
            arr(3 * d, scale=0.1), arr(d, d, scale=d ** -0.5))
    return x, g, args


def _scaled_err(got, want):
    """Largest difference over the largest element of the plain version."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max())


# gradients on the card, relative to each output's largest element: fp32 by
# summation order; bf16 by single roundings of qkv, dmg, p and ds that a
# different order can flip (one bf16 step is 2^-8)
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def test_cpu_backward_wrappers_take_the_plain_versions(gen):
    x, g, args = _block_case(gen, "cpu", torch.float32, 2, 5, 16)
    before = fab.fused_attention_block_bwd.launches
    got = fab.fused_attention_block_bwd(x, g, *args, n_heads=2, causal=True)
    want = fab.fused_attention_block_bwd_plain(x, g, *args, n_heads=2, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fab.fused_attention_block_bwd.launches == before
    q, k, v, g = (torch.from_numpy(gen.standard_normal((2, 2, 9, 8)).astype(np.float32))
                  for _ in range(4))
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
    assert torch.equal(fa.flash_attention(q, k, v, is_causal=True),
                       fa.flash_attention_fwd_plain(q, k, v, is_causal=True, scale=8 ** -0.5))
    got = fa.flash_attention_bwd(q, k, v, g, is_causal=False, scale=0.3)
    want = fa.flash_attention_bwd_plain(q, k, v, g, is_causal=False, scale=0.3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches) == before


@pytest.mark.cuda
def test_attention_block_output_has_grad_fn_on_card(gen, cuda_device):
    """K1 under autograd: the output joins the graph, and the backward is K3."""
    x, _, args = _block_case(gen, cuda_device, torch.float32, 2, 50, 64)
    ln = {"scale": args[0].requires_grad_(), "bias": args[1]}
    attn = {"w_qkv": args[2], "b_qkv": args[3], "w_out": args[4],
            "b_out": torch.zeros(64, device=cuda_device)}
    before = fab.fused_attention_block_bwd.launches
    out = fab.fused_attention_block(x, ln, attn, n_heads=4)
    assert out.grad_fn is not None
    out.sum().backward()
    torch.cuda.synchronize()
    assert ln["scale"].grad is not None and fab.fused_attention_block_bwd.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(36, 50, 768, 12, False), (36, 77, 512, 8, True),
                                   (9, 77, 768, 12, True)])
def test_attention_block_backward_kernel_on_card(shape, dtype, gen, cuda_device):
    b, t, d, h, causal = shape
    x, g, args = _block_case(gen, cuda_device, dtype, b, t, d)
    before = fab.fused_attention_block_bwd.launches
    got = fab.fused_attention_block_bwd(x, g, *args, n_heads=h, causal=causal)
    want = fab.fused_attention_block_bwd_plain(x, g, *args, n_heads=h, causal=causal)
    torch.cuda.synchronize()
    assert fab.fused_attention_block_bwd.launches == before + 1
    for name, a, w in zip(("dx", "dqkv", "merged", "dln_s", "dln_b"), got, want):
        assert _scaled_err(a, w) <= GRAD_TOL[dtype], name


# K3's tensor-core route (fab.route: bf16 at dh=64): the training towers'
# shapes, and the edges of its 64-row tiles (T = 1, a lone key; 64, one whole
# tile; 65, one row in the last; 256, the gate) at 3 rows a batch
K3_TC_CASES = ([(36, 50, 768, 12, False), (36, 77, 512, 8, True), (9, 77, 768, 12, True)] +
               [(3, t, 128, 2, causal) for t in (1, 64, 65, 256) for causal in (False, True)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K3_TC_CASES)
def test_attention_block_backward_tensor_cores_on_card(shape, gen, cuda_device):
    b, t, d, h, causal = shape
    x, g, args = _block_case(gen, cuda_device, torch.bfloat16, b, t, d)
    wrapper = fab.fused_attention_block_bwd
    before = (wrapper.launches, wrapper.tc_launches)
    got = wrapper(x, g, *args, n_heads=h, causal=causal)
    want = fab.fused_attention_block_bwd_plain(x, g, *args, n_heads=h, causal=causal)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.tc_launches) == (before[0] + 1, before[1] + 1)
    for name, a, w in zip(("dx", "dqkv", "merged", "dln_s", "dln_b"), got, want):
        assert _within(a, w, GRAD_TOL[torch.bfloat16]), name
    # fixed-order sums, no atomics: a second call gives the same bits
    again = wrapper(x, g, *args, n_heads=h, causal=causal, with_h=True)
    assert all(torch.equal(a, c) for a, c in zip(again, got))
    # the route hands back T(LN(x)) for W_qkv's gradient: one bf16 rounding of
    # statistics summed in another order apart from layer_norm's
    assert _within(again[5], fab.layer_norm(x, args[0], args[1]), 2 ** -7)


@pytest.mark.cuda
def test_attention_block_backward_tensor_core_entry_refuses_what_it_does_not_take(
        gen, cuda_device):
    """The tensor-core C entry refuses fp32 and other head widths with an
    error; it never runs them on the SIMT chain."""
    lib = _build.load_library()
    for dtype, d, h in ((torch.float32, 128, 2), (torch.bfloat16, 128, 4)):   # dh 64, 32
        x, g, args = _block_case(gen, cuda_device, dtype, 2, 8, d)
        work_t = torch.empty(2 * 8 * 4 * d, dtype=dtype, device=cuda_device)
        work_f = torch.empty(lib.cct_attention_block_bwd_work_floats(2, 8, d, h),
                             dtype=torch.float32, device=cuda_device)
        outs = [torch.empty_like(x), torch.empty(2, 8, 3 * d, dtype=dtype, device=cuda_device),
                torch.empty_like(x), torch.empty(d, device=cuda_device),
                torch.empty(d, device=cuda_device)]
        err = lib.cct_attention_block_bwd_tc(
            _build.dtype_code(dtype), x.data_ptr(), g.data_ptr(), *(a.data_ptr() for a in args),
            work_t.data_ptr(), work_f.data_ptr(), *(o.data_ptr() for o in outs), 2, 8, d, h, 0,
            1e-5, (d // h) ** -0.5, torch.cuda.current_stream().cuda_stream)
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.check(err, "fused_attention_block_bwd")


# K1's tensor-core route (fab.route: bf16 at dh=64): every shape of
# chip_smoke.K1_SHAPES, and the edges of the 64-row tiles (T = 1, a lone key;
# 64, one whole tile; 65, one row in the last; 256, the gate) at 3 rows a batch
K1_TC_CASES = ([(8, 50, 768, 12, False), (9, 77, 512, 8, True), (2, 77, 512, 8, True),
                (36, 50, 768, 12, False), (36, 77, 512, 8, True), (9, 77, 768, 12, True)] +
               [(3, t, 128, 2, causal) for t in (1, 64, 65, 256) for causal in (False, True)])


def _b_out(gen, dev, dtype, d):
    return torch.from_numpy(gen.standard_normal(d).astype(np.float32) * 0.1).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K1_TC_CASES)
def test_attention_block_tensor_cores_on_card(shape, gen, cuda_device):
    b, t, d, h, causal = shape
    x, _, args = _block_case(gen, cuda_device, torch.bfloat16, b, t, d)
    args = (*args, _b_out(gen, cuda_device, torch.bfloat16, d))
    wrapper = fab.fused_attention_block
    before = (wrapper.launches, wrapper.tc_launches)
    got = fab.fused_attention_block_fwd(x, *args, n_heads=h, causal=causal)
    want = fab.fused_attention_block_plain(x, *args, n_heads=h, causal=causal)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.tc_launches) == (before[0] + 1, before[1] + 1)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **CARD_TOL[torch.bfloat16])
    # no atomics: a second call gives the same bits
    assert torch.equal(fab.fused_attention_block_fwd(x, *args, n_heads=h, causal=causal), got)


@pytest.mark.cuda
def test_attention_block_tensor_core_entry_refuses_what_it_does_not_take(gen, cuda_device):
    """K1's tensor-core C entry refuses fp32, other head widths and T > 256
    with an error; it never runs them on the SIMT chain. The wrapper raises on
    T > 256 before any launch."""
    lib = _build.load_library()
    for dtype, t, d, h in ((torch.float32, 8, 128, 2), (torch.bfloat16, 8, 128, 4),
                           (torch.bfloat16, 257, 128, 2)):   # dh 64, 32; T past the gate
        x, _, args = _block_case(gen, cuda_device, dtype, 2, t, d)
        args = (*args, _b_out(gen, cuda_device, dtype, d))
        qkv = torch.empty(2 * t, 3 * d, dtype=dtype, device=cuda_device)
        merged = torch.empty(2 * t, d, dtype=dtype, device=cuda_device)
        out = torch.empty_like(x)
        err = lib.cct_attention_block_fwd_tc(
            _build.dtype_code(dtype), x.data_ptr(), *(a.data_ptr() for a in args),
            qkv.data_ptr(), merged.data_ptr(), out.data_ptr(), 2, t, d, h, 0, 1e-5,
            (d // h) ** -0.5, torch.cuda.current_stream().cuda_stream)
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.check(err, "fused_attention_block")
    before = (fab.fused_attention_block.launches, fab.fused_attention_block.tc_launches)
    with pytest.raises(ValueError, match="does not take"):
        fab.fused_attention_block_fwd(x, *args, n_heads=2)
    assert (fab.fused_attention_block.launches, fab.fused_attention_block.tc_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 50, 768, 12, False), (4, 77, 512, 8, True)])
def test_attention_block_autograd_on_tensor_cores_on_card(shape, gen, cuda_device):
    """K1 forward and K3 backward through autograd, both on the tensor-core
    route: the output and every gradient of the Function within GRAD_TOL of
    the same Function on CPU copies, where it runs the plain versions."""
    b, t, d, h, causal = shape
    x, g, args = _block_case(gen, cuda_device, torch.bfloat16, b, t, d)
    inputs = (x, *args, _b_out(gen, cuda_device, torch.bfloat16, d))

    def run(tensors, grad):
        leaves = [a.detach().clone().requires_grad_() for a in tensors]
        out = fab.fused_attention_block(
            leaves[0], {"scale": leaves[1], "bias": leaves[2]},
            dict(zip(("w_qkv", "b_qkv", "w_out", "b_out"), leaves[3:])), n_heads=h,
            causal=causal)
        return out, torch.autograd.grad(out, leaves, grad)

    counters = (fab.fused_attention_block, fab.fused_attention_block_bwd)
    before = [w.tc_launches for w in counters]
    out, got = run(inputs, g)
    torch.cuda.synchronize()
    assert [w.tc_launches for w in counters] == [n + 1 for n in before]
    want_out, want = run([a.cpu() for a in inputs], g.cpu())
    np.testing.assert_allclose(out.detach().float().cpu().numpy(),
                               want_out.detach().float().numpy(), **CARD_TOL[torch.bfloat16])
    names = ("x", "ln_scale", "ln_bias", "w_qkv", "b_qkv", "w_out", "b_out")
    for name, a, w in zip(names, got, want):
        assert _within(a.cpu(), w, GRAD_TOL[torch.bfloat16]), name


# K2 at beam 3 of one image, one row, and 8 images x beam 3 (the chunk count
# falls from several chunks a (row, head) to one); every cache length class:
# the first position alone, about a 64-position boundary, the last position,
# and past the cache (n_valid = t_max)
K2_CARD_T_MAX = 150
K2_CARD_CACHE_LENS = (0, 63, 64, 139, K2_CARD_T_MAX - 1, K2_CARD_T_MAX + 5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_ancestry", [False, True])
@pytest.mark.parametrize("rows", [1, 3, 24])
def test_decode_attention_cases_on_card(rows, with_ancestry, dtype, gen, cuda_device):
    layers, heads, t_max, dh = 2, 12, K2_CARD_T_MAX, 64
    ck, cv = (torch.from_numpy(gen.standard_normal((layers, rows, heads, t_max, dh))
                               .astype(np.float32)).to(cuda_device, dtype) for _ in range(2))
    q = torch.from_numpy(gen.standard_normal((rows, heads, dh)).astype(np.float32)).to(
        cuda_device, dtype)
    anc = (torch.from_numpy(gen.integers(0, rows, (rows, t_max), dtype=np.int32)).to(cuda_device)
           if with_ancestry else None)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    for cache_len in K2_CARD_CACHE_LENS:
        got = dec.decode_step_attention(q, ck, cv, 1, cache_len, anc)
        want = dec.decode_step_attention_plain(q, ck, cv, 1, min(cache_len, t_max - 1), anc)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   err_msg=f"cache_len {cache_len}", **tol)
        # chunks merged in a fixed order, no float atomics: the same bits again
        assert torch.equal(dec.decode_step_attention(q, ck, cv, 1, cache_len, anc), got)
    # 16-byte loads: a head width that is no whole number of them is refused
    with pytest.raises(ValueError, match="16 bytes"):
        dec.decode_step_attention(q[..., :30].contiguous(), ck[..., :30].contiguous(),
                                  cv[..., :30].contiguous(), 1, 5, anc)


# bf16 at dh=64 takes the tensor-core route (fa.route): the edges of its 64-row
# tiles (T=1, a lone key; 63, 64, 65 about one tile; 77, the text towers; 257,
# ViT-L/14; 1024, the gate), causal and not. fp32, and bf16 at another head
# width, take the SIMT route.
FLASH_CASES = ([((2, 3, t, 64, causal), torch.bfloat16)
                for t in (1, 63, 64, 65, 77, 257, 1024) for causal in (False, True)] +
               [((9, 16, 257, 64, False), torch.bfloat16), ((9, 12, 77, 64, True), torch.bfloat16),
                ((9, 16, 257, 64, False), torch.float32), ((9, 12, 77, 64, True), torch.float32),
                ((2, 3, 77, 32, True), torch.bfloat16)])


def _within(got, want, tol):
    """Largest difference within `tol` of the plain version's largest element
    (both may be all zero: dq and dk of a lone key)."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dtype", FLASH_CASES)
def test_flash_attention_kernels_on_card(shape, dtype, gen, cuda_device):
    b, h, t, dh, causal = shape
    q, k, v, g = (torch.from_numpy(gen.standard_normal((b, h, t, dh)).astype(np.float32))
                  .to(cuda_device, dtype) for _ in range(4))
    scale = dh ** -0.5
    route = f"{fa.route(dtype, dh)}_launches"
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd)
    before = [(w.launches, getattr(w, route)) for w in wrappers]
    out = fa.flash_attention_fwd(q, k, v, is_causal=causal, scale=scale)
    grads = fa.flash_attention_bwd(q, k, v, g, is_causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert [(w.launches, getattr(w, route)) for w in wrappers] == \
        [(n + 1, r + 1) for n, r in before]
    want = fa.flash_attention_fwd_plain(q, k, v, is_causal=causal, scale=scale)
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(),
                               **CARD_TOL[dtype])
    for name, a, w in zip(("dq", "dk", "dv"), grads,
                          fa.flash_attention_bwd_plain(q, k, v, g, is_causal=causal,
                                                       scale=scale)):
        assert _within(a, w, GRAD_TOL[dtype]), name
    # fixed-order sums, no atomics: a second call gives the same bits
    assert torch.equal(fa.flash_attention_fwd(q, k, v, is_causal=causal, scale=scale), out)
    again = fa.flash_attention_bwd(q, k, v, g, is_causal=causal, scale=scale)
    assert all(torch.equal(a, c) for a, c in zip(again, grads))


@pytest.mark.cuda
def test_flash_attention_tensor_core_entry_refuses_what_it_does_not_take(gen, cuda_device):
    """The tensor-core C entry refuses fp32 and other head widths with an
    error; it never runs them on the SIMT tiles."""
    lib = _build.load_library()
    for dtype, dh in ((torch.float32, 64), (torch.bfloat16, 32)):
        q = torch.zeros(1, 1, 8, dh, dtype=dtype, device=cuda_device)
        err = lib.cct_flash_attention_fwd_tc(
            _build.dtype_code(dtype), q.data_ptr(), q.data_ptr(), q.data_ptr(), q.data_ptr(),
            1, 1, 8, dh, 0, 0.125, torch.cuda.current_stream().cuda_stream)
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.check(err, "flash_attention")


def _vocab_case(gen, dev, rows, d, v, int8):
    w = gen.standard_normal((d, v)).astype(np.float32) * d ** -0.5
    x = torch.from_numpy(gen.standard_normal((rows, d)).astype(np.float32)).to(dev, torch.bfloat16)
    if not int8:
        return x, torch.from_numpy(w).to(dev, torch.bfloat16), None
    scale = np.abs(w).max(axis=0) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return x, torch.from_numpy(q).to(dev), torch.from_numpy(scale.astype(np.float32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("v", [250112, 1001])   # mT5-small's vocab, and an odd V
def test_vocab_head_kernel_on_card(v, rows, int8, gen, cuda_device):
    x, table, scale = _vocab_case(gen, cuda_device, rows, 512, v, int8)
    before = vh.vocab_head_logits.launches
    got = vh.vocab_head_logits(x, table, scale)
    want = vh.vocab_head_logits_plain(x, table, scale)
    torch.cuda.synchronize()
    assert vh.vocab_head_logits.launches == before + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, v)
    # fp32 sums of exact products in another order: relative to the largest logit
    assert _scaled_err(got, want) <= 1e-5
    assert torch.equal(got, vh.vocab_head_logits(x, table, scale))   # fixed order: same bits


@pytest.mark.cuda
def test_vocab_head_kernel_raises_on_what_it_does_not_take(gen, cuda_device):
    x, table, _ = _vocab_case(gen, cuda_device, 2, 64, 300, False)
    before = vh.vocab_head_logits.launches
    with pytest.raises(ValueError, match="bf16 or int8"):
        vh.vocab_head_logits(x, table.half())
    with pytest.raises(ValueError, match="rows"):
        vh.vocab_head_logits(x.repeat(5, 1), table)
    with pytest.raises(ValueError, match="fit"):
        vh.vocab_head_logits(x[:, :32], table)
    with pytest.raises(ValueError, match="scale"):
        vh.vocab_head_logits(x, table.to(torch.int8))
    with pytest.raises(ValueError, match="one device"):
        vh.vocab_head_logits(x, table.cpu())
    assert vh.vocab_head_logits.launches == before


def _int8_block_case(gen, dev, dtype, b, t, d):
    """x, LN params and int8-quantized attention params (ops/quant.quantize_tree)."""
    from construction_clip_tpu_torch.ops.quant import quantize_tree

    def arr(*s, scale=1.0, offset=0.0):
        a = gen.standard_normal(s).astype(np.float32) * scale + offset
        return torch.from_numpy(a).to(dev)

    attn = {"w_qkv": arr(d, 3 * d, scale=d ** -0.5), "b_qkv": arr(3 * d, scale=0.1).to(dtype),
            "w_out": arr(d, d, scale=d ** -0.5), "b_out": arr(d, scale=0.1).to(dtype)}
    qattn = quantize_tree(attn, [("w_qkv",), ("w_out",)])
    ln = {"scale": arr(d, scale=0.1, offset=1.0).to(dtype), "bias": arr(d, scale=0.1).to(dtype)}
    return arr(b, t, d).to(dtype), ln, qattn


def _int8_plain(x, ln, qattn, h, causal=False):
    return fab8.fused_attention_block_int8_plain(
        x, ln["scale"], ln["bias"], qattn["w_qkv"]["q"], qattn["w_qkv"]["s"], qattn["b_qkv"],
        qattn["w_out"]["q"], qattn["w_out"]["s"], qattn["b_out"], n_heads=h, causal=causal)


# K7 against its plain version, relative to the plain output's largest element.
# Both round at the same points; the LN statistics, the logits and p . v are
# summed in another order, and one ulp of difference in an fp32 row can move
# one int8 value by one step (about 7e-4 of the largest output at these scales,
# from the row scale times the weight scale times |q| <= 127). bf16 adds one
# rounding of qkv and of the output (2^-8 relative each), which such a step
# can flip.
INT8_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 50, 768, 12, False), (1, 50, 768, 12, False),
                                   (3, 50, 768, 12, False), (5, 77, 512, 8, True)])
def test_attention_block_int8_kernel_on_card(shape, dtype, gen, cuda_device):
    b, t, d, h, causal = shape
    x, ln, qattn = _int8_block_case(gen, cuda_device, dtype, b, t, d)
    before = fab8.fused_attention_block_int8.launches
    got = fab8.fused_attention_block_int8(x, ln, qattn, n_heads=h, causal=causal)
    want = _int8_plain(x, ln, qattn, h, causal)
    torch.cuda.synchronize()
    assert fab8.fused_attention_block_int8.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert _scaled_err(got, want) <= INT8_TOL[dtype]


@pytest.mark.cuda
def test_attention_block_int8_kernel_raises_on_what_it_does_not_take(gen, cuda_device):
    x, ln, qattn = _int8_block_case(gen, cuda_device, torch.bfloat16, 2, 50, 64)
    before = fab8.fused_attention_block_int8.launches
    with pytest.raises(ValueError, match="does not take"):
        fab8.fused_attention_block_int8(x.half(), ln, qattn, n_heads=4)
    with pytest.raises(ValueError, match="does not take"):
        fab8.fused_attention_block_int8(x.repeat(1, 6, 1), ln, qattn, n_heads=4)  # T 300
    float_w = dict(qattn, w_qkv={"q": qattn["w_qkv"]["q"].float(), "s": qattn["w_qkv"]["s"]})
    with pytest.raises(ValueError, match="w_qkv.q"):
        fab8.fused_attention_block_int8(x, ln, float_w, n_heads=4)
    strided = dict(qattn, w_out={"q": qattn["w_out"]["q"],
                                 "s": torch.zeros(128, device=cuda_device)[::2]})
    with pytest.raises(ValueError, match="w_out.s"):
        fab8.fused_attention_block_int8(x, ln, strided, n_heads=4)
    with pytest.raises(ValueError, match="b_qkv"):
        fab8.fused_attention_block_int8(x, ln, dict(qattn, b_qkv=qattn["b_qkv"].float()),
                                        n_heads=4)
    assert fab8.fused_attention_block_int8.launches == before


# K7's tensor-core route (fab8.route: bf16 at dh=64): every shape of
# chip_smoke.K7_SHAPES, and the edges of the 64-row tiles (T = 1, a lone key;
# 64, one whole tile; 65, one row in the last; 197, ViT-B/16's image tower;
# 256, the gate) at 3 rows a batch
K7_TC_CASES = ([(8, 50, 768, 12, False), (1, 50, 768, 12, False)] +
               [(3, t, 128, 2, causal) for t in (1, 64, 65, 197, 256)
                for causal in (False, True)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K7_TC_CASES)
def test_attention_block_int8_tensor_cores_on_card(shape, gen, cuda_device):
    b, t, d, h, causal = shape
    x, ln, qattn = _int8_block_case(gen, cuda_device, torch.bfloat16, b, t, d)
    wrapper = fab8.fused_attention_block_int8
    before = (wrapper.launches, wrapper.tc_launches)
    got = wrapper(x, ln, qattn, n_heads=h, causal=causal)
    want = _int8_plain(x, ln, qattn, h, causal)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.tc_launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert _scaled_err(got, want) <= INT8_TOL[torch.bfloat16]
    # no atomics: a second call gives the same bits
    assert torch.equal(wrapper(x, ln, qattn, n_heads=h, causal=causal), got)


def _int8_entry(entry, x, ln, qattn, h, causal):
    """Calls a K7 C entry with scratch the test keeps: -> out, and the int8
    rows and scales of the merged heads that the out product read."""
    b, t, d = x.shape
    dev = x.device
    args = (ln["scale"], ln["bias"], qattn["w_qkv"]["q"], qattn["w_qkv"]["s"], qattn["b_qkv"],
            qattn["w_out"]["q"], qattn["w_out"]["s"], qattn["b_out"])
    q8 = torch.empty((b * t, d), dtype=torch.int8, device=dev)
    rs = torch.empty(b * t, dtype=torch.float32, device=dev)
    qkv = torch.empty((b * t, 3 * d), dtype=x.dtype, device=dev)
    merged = torch.empty((b * t, d), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    err = entry(_build.dtype_code(x.dtype), x.data_ptr(), *(a.data_ptr() for a in args),
                q8.data_ptr(), rs.data_ptr(), qkv.data_ptr(), merged.data_ptr(), out.data_ptr(),
                b, t, d, h, int(causal), 1e-5, (d // h) ** -0.5,
                torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fused_attention_block_int8")
    return out, q8, rs


# (entry, dtype, shape): both entries at the tower shapes, and D = 72 (not a
# multiple of 16) on the SIMT entry, where the products run on __dp4a
K7_EXACT_CASES = ([("simt", dtype, shape) for dtype in (torch.float32, torch.bfloat16)
                   for shape in ((8, 50, 768, 12, False), (3, 77, 512, 8, True),
                                 (2, 9, 72, 2, False))] +
                  [("tc", torch.bfloat16, shape) for shape in ((8, 50, 768, 12, False),
                                                               (3, 77, 512, 8, True))])


@pytest.mark.cuda
@pytest.mark.parametrize("route, dtype, shape", K7_EXACT_CASES)
def test_attention_block_int8_products_are_exact_on_card(route, dtype, shape, gen,
                                                         cuda_device):
    """The out product, on the tensor cores (wgmma s8) where D % 16 == 0 and on
    __dp4a elsewhere, gives the bits of the exact int32 product (torch._int_mm)
    under the same epilogue, T((x + float(mq W_out) ms s_out) + b_out): so the
    two GEMMs give the same bits (the qkv product runs the same GEMM with its
    own epilogue)."""
    from construction_clip_tpu_torch.ops.quant import int8_matmul

    b, t, d, h, causal = shape
    lib = _build.load_library()
    entry = lib.cct_attention_block_int8_tc if route == "tc" else lib.cct_attention_block_int8
    x, ln, qattn = _int8_block_case(gen, cuda_device, dtype, b, t, d)
    out, mq, ms = _int8_entry(entry, x, ln, qattn, h, causal)
    acc = int8_matmul(mq, qattn["w_out"]["q"]).float()
    y = (acc * ms[:, None]) * qattn["w_out"]["s"]
    want = ((x.float().reshape(b * t, d) + y) + qattn["b_out"].float()).to(dtype)
    torch.cuda.synchronize()
    assert torch.equal(out.reshape(b * t, d), want)
    assert fab8.gemm_route(d) == ("wgmma" if d % 16 == 0 else "dp4a")


@pytest.mark.cuda
def test_attention_block_int8_tensor_core_entry_refuses_what_it_does_not_take(gen, cuda_device):
    """K7's tensor-core C entry refuses fp32, other head widths and T > 256
    with an error; it never runs them on the SIMT entry."""
    lib = _build.load_library()
    for dtype, t, d, h in ((torch.float32, 8, 128, 2), (torch.bfloat16, 8, 128, 4),
                           (torch.bfloat16, 257, 128, 2)):   # dh 64, 32; T past the gate
        x, ln, qattn = _int8_block_case(gen, cuda_device, dtype, 2, t, d)
        with pytest.raises(RuntimeError, match="CUDA error"):
            _int8_entry(lib.cct_attention_block_int8_tc, x, ln, qattn, h, False)


@pytest.mark.cuda
def test_failed_build_raises_instead_of_falling_back(gen, cuda_device, tmp_path, monkeypatch):
    """No nvcc and no built library: the wrapper raises; it never takes the
    plain version on a CUDA tensor."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    x, ln, qattn = _int8_block_case(gen, cuda_device, torch.bfloat16, 2, 50, 64)
    before = fab8.fused_attention_block_int8.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        fab8.fused_attention_block_int8(x, ln, qattn, n_heads=4)
    assert fab8.fused_attention_block_int8.launches == before


def _mlp_case(gen, dev, dtype, b, t, d, hidden):
    def arr(*s, scale=1.0, offset=0.0):
        a = gen.standard_normal(s).astype(np.float32) * scale + offset
        return torch.from_numpy(a).to(dev, dtype)

    return (arr(b, t, d), arr(d, scale=0.1, offset=1.0), arr(d, scale=0.1),
            arr(d, hidden, scale=d ** -0.5), arr(hidden, scale=0.1),
            arr(hidden, d, scale=hidden ** -0.5), arr(d, scale=0.1))


def _mlp_call(fn, args):
    x, s, b, wf, bf, wp, bp = args
    return fn(x, {"w_fc": wf, "b_fc": bf, "w_proj": wp, "b_proj": bp}, {"scale": s, "bias": b})


def test_cpu_mlp_and_normalize_take_the_plain_versions(gen):
    args = _mlp_case(gen, "cpu", torch.float32, 2, 5, 16, 64)
    before = mlp.fused_mlp_residual.launches
    assert torch.equal(_mlp_call(mlp.fused_mlp_residual, args),
                       mlp.fused_mlp_residual_plain(*args))
    assert mlp.fused_mlp_residual.launches == before
    u8 = torch.from_numpy((gen.random((2, 5, 7, 3)) * 256).astype(np.uint8))
    before = norm.normalize_u8.launches
    kw = dict(mean=(0.5, 0.4, 0.3), std=(0.2, 0.25, 0.3))
    assert torch.equal(norm.normalize_u8(u8, **kw), norm.normalize_u8_plain(u8, **kw))
    assert norm.normalize_u8.launches == before


# K9 against its plain version on the card, relative to the plain output's
# largest element: fp32 by summation order (the LN statistics and both GEMMs);
# bf16 adds single roundings of h, the pre-activation, the QuickGELU steps and
# the output that another order can flip (one bf16 step is 2^-8)
MLP_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 50, 768, 3072), (9, 77, 512, 2048),
                                   (36, 50, 768, 3072), (3, 7, 40, 100)])
def test_mlp_residual_kernel_on_card(shape, dtype, gen, cuda_device):
    args = _mlp_case(gen, cuda_device, dtype, *shape)
    before = mlp.fused_mlp_residual.launches
    got = _mlp_call(mlp.fused_mlp_residual, args)
    want = mlp.fused_mlp_residual_plain(*args)
    torch.cuda.synchronize()
    assert mlp.fused_mlp_residual.launches == before + 1
    assert got.dtype == dtype and got.shape == args[0].shape
    assert _scaled_err(got, want) <= MLP_TOL[dtype]


# K9's tensor-core route (mlp.route: bf16 with D and the hidden multiples of
# 8): every bf16 shape of chip_smoke.K9_RUNS, and rows that fill no 64-row tile
K9_TC_CASES = [(8, 50, 768, 3072), (36, 50, 768, 3072), (9, 77, 512, 2048), (3, 7, 40, 104)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K9_TC_CASES)
def test_mlp_residual_tensor_cores_on_card(shape, gen, cuda_device):
    args = _mlp_case(gen, cuda_device, torch.bfloat16, *shape)
    wrapper = mlp.fused_mlp_residual
    before = (wrapper.launches, wrapper.tc_launches)
    got = _mlp_call(wrapper, args)
    want = mlp.fused_mlp_residual_plain(*args)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.tc_launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.bfloat16 and got.shape == args[0].shape
    assert _scaled_err(got, want) <= MLP_TOL[torch.bfloat16]
    assert torch.equal(_mlp_call(wrapper, args), got)   # no atomics: the same bits again


@pytest.mark.cuda
def test_mlp_residual_tensor_core_entry_refuses_what_it_does_not_take(gen, cuda_device):
    """K9's tensor-core C entry refuses fp32 and widths that are no multiple of
    8 with an error; it never runs them on the SIMT chain."""
    lib = _build.load_library()
    for dtype, d, hidden in ((torch.float32, 64, 256), (torch.bfloat16, 44, 176),
                             (torch.bfloat16, 40, 100)):
        args = _mlp_case(gen, cuda_device, dtype, 2, 5, d, hidden)
        h = torch.empty(10, hidden, dtype=dtype, device=cuda_device)
        out = torch.empty_like(args[0])
        err = lib.cct_mlp_residual_tc(
            _build.dtype_code(dtype), *(a.data_ptr() for a in args), h.data_ptr(),
            out.data_ptr(), 10, d, hidden, 1e-5, torch.cuda.current_stream().cuda_stream)
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.check(err, "fused_mlp_residual")


@pytest.mark.cuda
def test_mlp_residual_output_has_grad_fn_on_card(gen, cuda_device):
    """K9 under autograd: the output joins the graph, and the backward (the
    composable math's gradient) matches the plain path's."""
    args = [a.requires_grad_() for a in _mlp_case(gen, cuda_device, torch.float32, 2, 50, 64,
                                                  256)]
    out = _mlp_call(mlp.fused_mlp_residual, args)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out.square().sum(), args)
    want = torch.autograd.grad(mlp._ref_math(*args, 1e-5).square().sum(), args)
    for a, w in zip(got, want):
        assert _scaled_err(a, w) <= 1e-4


@pytest.mark.cuda
def test_mlp_residual_kernel_raises_on_what_it_does_not_take(gen, cuda_device):
    args = _mlp_case(gen, cuda_device, torch.bfloat16, 2, 5, 64, 256)
    before = mlp.fused_mlp_residual.launches
    with pytest.raises(ValueError, match="does not take"):
        mlp.fused_mlp_residual_fwd(args[0].half(), *args[1:])
    with pytest.raises(ValueError, match="w_fc"):
        mlp.fused_mlp_residual_fwd(args[0], args[1], args[2], args[3].float(), *args[4:])
    with pytest.raises(ValueError, match="w_proj"):
        mlp.fused_mlp_residual_fwd(*args[:5], args[5].mT, args[6])   # not contiguous
    with pytest.raises(ValueError, match="b_fc"):
        mlp.fused_mlp_residual_fwd(*args[:4], args[4][:100], *args[5:])
    with pytest.raises(ValueError, match="ln_scale"):
        mlp.fused_mlp_residual_fwd(args[0], args[1].cpu(), *args[2:])
    assert mlp.fused_mlp_residual.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 224, 224, 3), (256, 224, 224, 3), (1, 7, 5, 3),
                                   (2, 3, 1, 3)])
def test_normalize_u8_kernel_on_card(shape, out_dtype, gen, cuda_device):
    """Bit-equal to its plain version: the same fp32 operations, each rounded
    (a thread's 16-byte store of 8 bf16 or 4 fp32 elements; no grid-stride
    loop runs at these shapes, only past 2^31 blocks; a scalar tail of 1
    element at (1, 7, 5, 3), 105 elements, and of 2 at (2, 3, 1, 3), 18)."""
    u8 = torch.from_numpy((gen.random(shape) * 256).astype(np.uint8)).to(cuda_device)
    kw = dict(mean=(0.48145466, 0.4578275, 0.40821073),
              std=(0.26862954, 0.26130258, 0.27577711), out_dtype=out_dtype)
    before = norm.normalize_u8.launches
    got = norm.normalize_u8(u8, **kw)
    torch.cuda.synchronize()
    assert norm.normalize_u8.launches == before + 1
    assert got.dtype == out_dtype and got.shape == u8.shape
    assert torch.equal(got, norm.normalize_u8_plain(u8, **kw))
    # an input one byte into its storage takes the scalar path
    flat = torch.zeros(u8.numel() + 1, dtype=torch.uint8, device=cuda_device)
    flat[1:] = u8.flatten()
    assert torch.equal(norm.normalize_u8(flat[1:].view(shape), **kw), got)


@pytest.mark.cuda
def test_normalize_u8_kernel_raises_on_what_it_does_not_take(gen, cuda_device):
    u8 = torch.zeros((2, 4, 4, 3), dtype=torch.uint8, device=cuda_device)
    kw = dict(mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))
    before = norm.normalize_u8.launches
    with pytest.raises(ValueError, match="uint8"):
        norm.normalize_u8(u8.float(), **kw)
    with pytest.raises(ValueError, match="uint8"):
        norm.normalize_u8(u8[..., :1], **kw)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        norm.normalize_u8(u8, out_dtype=torch.float16, **kw)
    assert norm.normalize_u8.launches == before


# K10: [9, 512] is the ViT-B/32 path's feature chunk (9 rows a rank); 13 and 515
# columns give chunks that are no multiple of 16 bytes (the kernel then copies
# in 4- or 2-byte units)
K10_CASES = (((9, 512), torch.float32), ((9, 512), torch.bfloat16), ((9, 768), torch.float32),
             ((9, 13), torch.float32), ((9, 13), torch.bfloat16), ((9, 515), torch.float32),
             ((9, 515), torch.bfloat16))


def _k10_rows(shape, rank, dtype, device):
    """Integers (exact in bf16 below 256) that name the rank."""
    n = shape[0] * shape[1]
    vals = (torch.arange(n) % 97 + 100 * rank).float().reshape(shape)
    return vals.to(device, dtype)


def _k10_rank(dp, cases):
    """K10 against its plain version for each case; then a chunk above the
    slot; then the autograd gather's backward."""
    from construction_clip_tpu_torch.parallel.infonce import _GatherRows

    equal = []
    for shape, dtype in cases:
        x = _k10_rows(shape, dp.rank, dtype, dp.device)
        before = coll.all_gather.launches
        got = coll.all_gather(x, dp)
        torch.cuda.synchronize()
        equal.append(bool(torch.equal(got, coll.all_gather_plain(x, dp)))
                     and coll.all_gather.launches == before + 1)
    too_big = torch.zeros((dp.peers.capacity // 4 + 1, 1), device=dp.device)
    try:
        coll.all_gather(too_big, dp)
        refused = False
    except ValueError as e:
        refused = "exceeds" in str(e)
    # rank r weights the gathered rows by w_r; rank p's gradient is the sum
    # over r of w_r's rows of rank p (integers: the sums are exact)
    shape = (3, 5)
    x = _k10_rows(shape, dp.rank, torch.float32, dp.device).requires_grad_()

    def weights(r):
        return _k10_rows((dp.world * shape[0], shape[1]), r, torch.float32, dp.device) - 50

    (_GatherRows.apply(x, dp) * weights(dp.rank)).sum().backward()
    rows = slice(dp.rank * shape[0], (dp.rank + 1) * shape[0])
    want = sum(weights(r)[rows] for r in range(dp.world))
    return equal, refused, bool(torch.equal(x.grad, want))


@pytest.mark.cuda
def test_all_gather_kernel_on_card(cuda_device):
    """K10 with 2 ranks sharing the card (CUDA IPC between two processes):
    bit-equal to its plain version at each case, one launch a call; a chunk
    above the slot's capacity raises before any rank waits; the autograd
    gather's backward gives the reduce-scattered gradient."""
    from construction_clip_tpu_torch.core.mesh import spawn_ranks

    _build.load_library()   # built once here, loaded by the ranks
    results = spawn_ranks(_k10_rank, 2, (K10_CASES,), device="cuda:0", timeout=120)
    for equal, refused, grad_ok in results:
        assert equal == [True] * len(K10_CASES)
        assert refused and grad_ok


def _k10_call_rows(rank, call, device, shape=(9, 512)):
    """Rank `rank`'s rows at call `call`: integers exact in fp32, different for
    every rank and call, so that a stale slot shows."""
    n = shape[0] * shape[1]
    first = n * (rank + 2 * call)
    return torch.arange(first, first + n, device=device, dtype=torch.float32).view(shape)


def _k10_calls_rank(dp, calls, delay_s):
    """`calls` back-to-back calls (rank i % world sleeps `delay_s` before call
    i), with no synchronisation between them; then each output against the
    plain version of the same call's rows."""
    import time

    outs = []
    for i in range(calls):
        if delay_s and i % dp.world == dp.rank:
            time.sleep(delay_s)
        outs.append(coll.all_gather(_k10_call_rows(dp.rank, i, dp.device), dp))
    torch.cuda.synchronize()
    return [bool(torch.equal(out, coll.all_gather_plain(_k10_call_rows(dp.rank, i, dp.device),
                                                         dp)))
            for i, out in enumerate(outs)]


@pytest.mark.cuda
@pytest.mark.parametrize("calls, delay_s", [(200, 0.0), (50, 0.02)])
def test_all_gather_back_to_back_calls_on_card(calls, delay_s, cuda_device):
    """2 ranks on the card make `calls` calls without a host synchronisation,
    each with other rows; with a delay, one rank in turn reaches each call
    20 ms late, so that its peer's gather waits on the device: every output is
    bit-equal to the plain version of its own call (no stale slot)."""
    from construction_clip_tpu_torch.core.mesh import spawn_ranks

    _build.load_library()
    results = spawn_ranks(_k10_calls_rank, 2, (calls, delay_s), device="cuda:0", timeout=120)
    assert results == [[True] * calls] * 2


def _k10_lost_peer_rank(dp, then_softmax):
    """Rank 0 calls, with `then_softmax` launches log_softmax on the output (a
    kernel this process has not launched yet, as the InfoNCE loss does after
    its gathers), and synchronises; rank 1 never calls."""
    if dp.rank == 0:
        out = coll.all_gather(torch.ones((9, 512), device=dp.device), dp)
        if then_softmax:
            torch.log_softmax(out, dim=-1)
        torch.cuda.synchronize()
    return dp.rank


@pytest.mark.cuda
@pytest.mark.parametrize("then_softmax", [False, True])
def test_all_gather_fails_at_the_deadline_when_a_peer_never_calls(then_softmax, cuda_device):
    """The wait for a peer's flag has a deadline (10 s): rank 0's gather traps,
    its synchronise raises, and spawn_ranks raises that rank's error well
    before its own timeout; nothing hangs, also where the host launches a
    kernel of a module it has not used yet behind the waiting gather (the
    ranks load every module when CUDA starts)."""
    import time

    from construction_clip_tpu_torch.core.mesh import spawn_ranks

    _build.load_library()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 failed"):
        spawn_ranks(_k10_lost_peer_rank, 2, (then_softmax,), device="cuda:0", timeout=60)
    assert time.monotonic() - t0 < 45


_LAZY_PEERS = """
import types, torch
from construction_clip_tpu_torch.ops import collectives
dp = types.SimpleNamespace(world=1, rank=0, device=torch.device("cuda:0"))
try:
    collectives.PeerBuffers(dp, 1024)
except RuntimeError as e:
    print(e)
"""


@pytest.mark.cuda
def test_peer_buffers_refuse_lazy_module_loading(cuda_device):
    """A process whose CUDA started with lazy module loading gets no
    PeerBuffers: its gather's deadline could not hold."""
    import subprocess
    import sys

    _build.load_library()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_MODULE_LOADING="LAZY")
    run = subprocess.run([sys.executable, "-c", _LAZY_PEERS], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "CUDA_MODULE_LOADING=EAGER" in run.stdout


def test_all_gather_needs_peer_buffers_on_card():
    """On a CUDA tensor the wrapper launches K10 or raises: without the
    ranks' PeerBuffers it raises (checked with a stand-in whose device is
    cuda, so no card is needed)."""
    class FakeCuda:
        device = torch.device("cuda")

        def dim(self):
            return 2

    dp = types.SimpleNamespace(peers=None, world=2, rank=0)
    with pytest.raises(RuntimeError, match="PeerBuffers"):
        coll.all_gather(FakeCuda(), dp)


class _FakeCudaRows:
    """A [chunk, D] fp32 stand-in whose device is cuda, so that the wrapper's
    card path runs without a card."""
    device = torch.device("cuda")
    dtype = torch.float32
    shape = (9, 512)

    def dim(self):
        return 2

    def detach(self):
        return self

    def contiguous(self):
        return self

    def numel(self):
        return 9 * 512

    def element_size(self):
        return 4

    def data_ptr(self):
        return 4096


def test_all_gather_on_card_neither_synchronises_nor_meets_a_barrier(monkeypatch):
    """The card path of `all_gather` only queues K10: with stand-ins for the
    card (torch.cuda's device, stream and synchronise, a library that records
    its calls) two calls each launch the put and then the gather once, with
    generations 1 and 2 on slots 1 and 0, an event recorded after each, and
    hand both events to the watchdog; neither calls torch.cuda.synchronize
    nor dp.barrier."""
    calls = []

    class Lib:
        def cct_all_gather_put(self, *args):
            calls.append(("put",) + args)
            return 0

        def cct_all_gather_gather(self, *args):
            calls.append(("gather",) + args)
            return 0

    class Stream:
        cuda_stream = 77

        def record_event(self):
            calls.append("event")
            return f"event {len(calls)}"

    def forbidden(*args, **kwargs):
        raise AssertionError("a call of all_gather synchronised or met a barrier")

    monkeypatch.setattr(_build, "load_library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    monkeypatch.setattr(torch, "empty", lambda shape, **kw: types.SimpleNamespace(
        shape=shape, data_ptr=lambda: 8192))
    dp = types.SimpleNamespace(world=2, rank=1, barrier=forbidden, peers=None)
    watched = []
    peers = types.SimpleNamespace(
        dp=dp, capacity=1 << 16, pad_offset=2 << 16, calls=0, host_bases="bases",
        bases=types.SimpleNamespace(data_ptr=lambda: 1024),
        watchdog=types.SimpleNamespace(watch=lambda *events: watched.append(events)))
    dp.peers = peers
    before = coll.all_gather.launches
    for _ in range(2):
        out = coll.all_gather(_FakeCudaRows(), dp)
        assert out.shape == (18, 512)
    assert coll.all_gather.launches == before + 2 and peers.calls == 2
    assert watched == [("event 2", "event 4"), ("event 6", "event 8")]
    chunk = 9 * 512 * 4
    expected = []
    for g, slot in ((1, 1 << 16), (2, 0)):
        # put: bases, slot_offset, pad_offset, x, chunk_bytes, ranks, me, generation,
        # stream; gather: bases, host_bases, slot_offset, pad_offset, x, out,
        # chunk_bytes, ranks, me, generation, stream
        expected += [("put", 1024, slot, 2 << 16, 4096, chunk, 2, 1, g, 77), "event",
                     ("gather", 1024, "bases", slot, 2 << 16, 4096, 8192, chunk, 2, 1, g, 77),
                     "event"]
    assert calls == expected


def test_peer_buffers_refuse_more_ranks_than_the_pad_holds():
    """The signal pad holds the flags of 31 ranks: a larger world is refused
    before anything touches a card."""
    with pytest.raises(ValueError, match="31 ranks"):
        coll.PeerBuffers(types.SimpleNamespace(world=coll.MAX_RANKS + 1), 1024)


class _Event:
    """An event that reports done from `done_at` (monotonic s) on."""

    def __init__(self, done_at):
        self.done_at = done_at

    def query(self):
        return time.monotonic() >= self.done_at


def _watch(calls, deadline_s):
    """A watchdog over `calls`, (put done at, gather done at) in monotonic s."""
    fired = threading.Event()
    dog = coll.WaitWatchdog(fired.set, deadline_s=deadline_s, poll_s=0.01)
    for put_at, done_at in calls:
        dog.watch(_Event(put_at), _Event(done_at))
    return dog, fired


def test_watchdog_fails_a_call_that_waits_past_its_deadline():
    """A call whose gather never completes fails once, a deadline after its
    put completed and not before it."""
    t0 = time.monotonic()
    dog, fired = _watch([(t0, t0), (t0 + 0.2, float("inf"))], deadline_s=0.3)
    assert fired.wait(5.0)
    assert time.monotonic() - t0 >= 0.5 and dog.fired
    dog.stop()


def test_watchdog_measures_each_call_from_its_put():
    """Calls whose gathers each complete within the deadline of their put do
    not fire it, though together they take longer than the deadline, and
    though the first put completes only after more than a deadline of work
    queued ahead of it; nor do calls that complete at once."""
    t0 = time.monotonic()
    calls = [(t0 + 0.4, t0 + 0.5)]
    calls += [(t0 + 0.5 + 0.15 * i, t0 + 0.5 + 0.15 * (i + 1)) for i in range(4)]
    dog, fired = _watch(calls + [(t0, t0)], deadline_s=0.3)
    time.sleep(1.4)
    assert not fired.is_set() and not dog.pending
    dog.stop()
    assert not dog.fired


# ---- the ClipCap slice on the card against the CPU ---------------------------------------

class _CharTokenizer:
    """Character-level stand-in for the BERT tokenizer over a vocab list
    ([CLS] + a character's id, or [UNK] + [SEP]; decode joins with spaces): the
    card's machine has no `tokenizers`."""

    def __init__(self, vocab):
        self.vocab, self.ids = vocab, {tok: i for i, tok in enumerate(vocab)}

    def encode(self, text):
        return [101] + [self.ids.get(c, 100) for c in text if not c.isspace()] + [102]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(self.vocab[int(i)] for i in ids
                        if not (skip_special_tokens and self.vocab[int(i)].startswith("[")))


def _clipcap_tiny(tmp_path):
    from construction_clip_tpu_torch import convert
    from construction_clip_tpu_torch.core.configs import CLIPConfig, ClipCapConfig, GPT2Config
    from construction_clip_tpu_torch.data import offline_assets
    from construction_clip_tpu_torch.data.clip_tokenizer import ClipTokenizer

    merges, vocab = str(tmp_path / "merges.txt.gz"), str(tmp_path / "vocab.txt")
    offline_assets.write_clip_merges(merges, n_merges=6)
    offline_assets.write_bert_vocab(vocab, offline_assets.corpus_characters([]), size=128)
    with open(vocab, encoding="utf-8") as f:
        lm_tok = _CharTokenizer(f.read().splitlines())
    cfg, gcfg = CLIPConfig.tiny_bpe(), GPT2Config.tiny()
    ccfg = ClipCapConfig(prefix_length=4, attribute_length=6, clip_dim=cfg.text.embed_dim,
                         only_prefix=False)
    return (convert.init_clip(0, cfg), convert.init_clipcap(1, ccfg, gcfg),
            (cfg, ccfg, gcfg), ClipTokenizer(merges), lm_tok)


@pytest.mark.cuda
@pytest.mark.parametrize("use_beam", [True, False], ids=["beam", "greedy"])
def test_predict_batch_on_card_equals_the_cpu(use_beam, tmp_path, gen, cuda_device):
    """One batch of the predict app's batch function at tiny width in fp32:
    the records on the card (K1 in both towers, K2 at every decode step)
    equal the CPU's (the plain versions)."""
    from construction_clip_tpu_torch import convert
    from construction_clip_tpu_torch.apps.predict import make_process
    from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY
    from construction_clip_tpu_torch.data.schema import Annotation

    clip_np, cap_np, (cfg, ccfg, gcfg), clip_tok, lm_tok = _clipcap_tiny(tmp_path)
    staged = (gen.random((4, 64, 64, 3)) * 255).astype(np.uint8)
    anns = [Annotation(id=i, file_name=f"{i}.jpg", caption=f"c{i}") for i in range(4)]
    records = {}
    for device in (torch.device("cpu"), cuda_device):
        for fn in (fab.fused_attention_block, dec.decode_step_attention):
            fn.launches = 0
        process = make_process(convert.to_params(clip_np, device=device), cfg,
                               convert.to_params(cap_np, device=device), ccfg, gcfg, clip_tok,
                               lm_tok, use_beam=use_beam, policy=DEFAULT_POLICY, device=device)
        with contextlib.redirect_stdout(None):
            records[device.type] = process(anns, staged)
        launched = (fab.fused_attention_block.launches, dec.decode_step_attention.launches)
        assert all(launched) == (device.type == "cuda"), launched
    assert records["cuda"] == records["cpu"]


@pytest.mark.cuda
def test_caption_step_on_card_equals_the_cpu(tmp_path, gen, cuda_device):
    """One full fine-tune caption step at tiny width in fp32 from the same
    params and batch: the loss to 1e-5 relative, and every gradient leaf by
    ||g_card - g_cpu|| / (||g_cpu|| + 1e-6 ||G||) <= 1e-4, G the whole CPU
    gradient (cuBLAS against the CPU's GEMMs: sums in another order; the
    second term keeps the key bias, whose gradient is rounding noise on both,
    from counting as a relative error)."""
    from construction_clip_tpu_torch import convert
    from construction_clip_tpu_torch.core.params import tree_leaves
    from construction_clip_tpu_torch.train import caption

    _, cap_np, (_, ccfg, gcfg), _, _ = _clipcap_tiny(tmp_path)
    tokens = gen.integers(1, gcfg.vocab_size, (4, 9)).astype(np.int32)
    tokens[1, 4:], tokens[3, 1:] = 0, 0
    batch = {"tokens": tokens,
             "prefix": gen.standard_normal((4, ccfg.clip_dim)).astype(np.float32),
             "attribute": gen.integers(1, gcfg.vocab_size, (4, 6)).astype(np.int32)}
    out = {}
    for device in (torch.device("cpu"), cuda_device):
        params = convert.to_params(cap_np, device=device, trainable=True)
        on = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        loss, grads = caption.loss_and_grads(params, None, ccfg, gcfg, on)
        out[device.type] = (float(loss), [g.cpu() for g in tree_leaves(grads)])
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    total = float(torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in gc])))
    for a, b in zip(gg, gc):
        err = float(torch.linalg.vector_norm(a - b) / (torch.linalg.vector_norm(b) + 1e-6 * total))
        assert err <= 1e-4, err
