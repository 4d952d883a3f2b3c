"""PyTorch port, the token lookup and its hand-written backward (ops/embedding.py,
csrc/embedding_bwd.cu). This file imports no JAX, so it also runs on a machine
that has a GPU and no JAX:

    python -m pytest tests/test_torch_embedding.py --noconftest -q

On the CPU: the lookup is `table[ids]` in value and gradient, the kernel's
route is taken only under the "kernel" impl, the plain backward sums in fp64
and rounds once, negative ids wrap as the gather wraps them, bad inputs raise,
and the kernel's order of sums (stable sort, pieces of 64 sorted rows, partial
slots, eight shares a cut run) is rehearsed in numpy. The tests marked `cuda` hold the kernel against an fp64
scatter-add on the card and skip where there is none (a CUDA kernel has no CPU
mode)."""

import numpy as np
import pytest
import torch

from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.ops import embedding as emb
from construction_clip_tpu_torch.ops.attention import use_impl

PIECE, SHARES = 64, 8   # csrc/embedding_bwd.cu: kPiece, kFinishWarps
MANTISSA = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}
CLIP_V, CLIP_T = 49408, 77


def _embed_bwd() -> int:
    return tracing.counters().get("embed_bwd", 0)


def clip_ids(gen, batch, vocab=CLIP_V, context=CLIP_T, eot=(8, 40)):
    """[batch, context] ids as the benchmark's cells make them: SOT first, ids
    below it, EOT (the largest id) at a position in eot, zeros after."""
    ends = gen.integers(eot[0], eot[1] + 1, (batch, 1))
    ids = gen.integers(1, vocab - 2, (batch, context))
    pos = np.arange(context)[None, :]
    ids = np.where(pos < ends, ids, 0)
    ids = np.where(pos == ends, vocab - 1, ids)
    ids[:, 0] = vocab - 2
    return ids


def _ulp(x, dtype):
    """One unit in the last place of dtype at the magnitude of x (float64)."""
    tiny = torch.finfo(dtype).tiny
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(tiny))) - MANTISSA[dtype])


def _reference(ids, grad, num_rows):
    """fp64 sums by id (a negative id wraps), and the sums of the rows'
    magnitudes."""
    flat, g = ids.reshape(-1).long() % num_rows, grad.reshape(-1, grad.shape[-1]).double()
    ref = torch.zeros((num_rows, g.shape[1]), dtype=torch.float64, device=g.device)
    mag = torch.zeros_like(ref)
    return ref.index_add_(0, flat, g), mag.index_add_(0, flat, g.abs())


def _assert_within_one_ulp(got, ids, grad, num_rows, chain=None):
    """got within 1 ulp of the fp64 sum rounded to its dtype. In fp32 a sum of
    fp32 adds cannot hold one fp32 ulp of the fp64 sum: there the bound adds
    the accumulation's own, chain x 2^-24 x the sum of magnitudes, the chain
    being the longest run of dependent adds: by default the kernel's (a piece,
    a share of N/64 + 1 partials, the 8 shares)."""
    ref, mag = _reference(ids, grad, num_rows)
    rounded = ref.to(got.dtype).double()
    g64 = got.double()
    bound = _ulp(torch.maximum(rounded.abs(), g64.abs()), got.dtype)
    if got.dtype == torch.float32:
        if chain is None:
            chain = PIECE + (ids.numel() // PIECE + 2) // SHARES + 1 + SHARES
        bound = bound + chain * 2.0 ** -24 * mag
    err = (g64 - rounded).abs()
    assert bool((err <= bound).all()), float((err / bound).max())


def _rehearse(ids, grad, num_rows):
    """csrc/embedding_bwd.cu's order of fp32 sums in numpy: a stable sort by id,
    pieces of 64 sorted rows, each run of equal ids summed in row order within
    a piece, a run wholly in a piece rounded there, a cut run's partials (slot
    1 of its first piece, slot 0 of each later one) summed in 8 contiguous
    shares, the shares in order. Returns the output and how often each row was
    written."""
    flat = np.asarray(ids).reshape(-1) % num_rows   # the keys: a negative id wraps
    g = np.asarray(grad, np.float32).reshape(flat.size, -1)
    n, d = g.shape
    order = np.argsort(flat, kind="stable")
    keys, rows = flat[order], order
    out = np.zeros((num_rows, d), np.float32)
    writes = np.zeros(num_rows, np.int64)
    slots = {}
    for piece in range(0, n, PIECE):
        stop = min(piece + PIECE, n)
        j = piece
        while j < stop:
            k, acc = keys[j], np.zeros(d, np.float32)
            began = j == piece and piece > 0 and keys[piece - 1] == k
            while j < stop and keys[j] == k:
                acc = acc + g[rows[j]]
                j += 1
            goes_on = j == stop and stop < n and keys[stop] == k
            if began or goes_on:
                slots[(piece // PIECE, 0 if began else 1)] = acc
            else:
                out[k], writes[k] = acc, writes[k] + 1
    for piece in range(0, n, PIECE):
        p = piece // PIECE
        k = keys[piece]
        ends_here = not (piece + PIECE < n and keys[piece + PIECE - 1] == k
                         and keys[piece + PIECE] == k)
        if piece == 0 or keys[piece - 1] != k or not ends_here:
            continue
        p0 = int(np.searchsorted(keys, k, side="left")) // PIECE
        parts = [slots[(p0, 1)]] + [slots[(q, 0)] for q in range(p0 + 1, p + 1)]
        m = len(parts)
        shares = []
        for w in range(SHARES):
            acc = np.zeros(d, np.float32)
            for part in parts[m * w // SHARES: m * (w + 1) // SHARES]:
                acc = acc + part
            shares.append(acc)
        total = shares[0]
        for s in shares[1:]:
            total = total + s
        out[k], writes[k] = total, writes[k] + 1
    present = np.zeros(num_rows, bool)
    present[flat] = True
    writes[~present] += 1   # the zero pass
    return out, writes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookup_on_cpu_is_indexing_in_value_and_gradient(dtype):
    gen = np.random.default_rng(3)
    table = torch.from_numpy(gen.standard_normal((300, 16)).astype(np.float32)).to(dtype)
    ids = torch.from_numpy(clip_ids(gen, 6, vocab=300, context=20, eot=(3, 9)))
    g = torch.from_numpy(gen.standard_normal((6, 20, 16)).astype(np.float32)).to(dtype)
    a, b = table.clone().requires_grad_(), table.clone().requires_grad_()
    before = _embed_bwd()
    got, want = emb.embedding(a, ids), b[ids]
    got.backward(g)
    want.backward(g)
    assert torch.equal(got, want) and torch.equal(a.grad, b.grad)
    assert _embed_bwd() == before
    with torch.no_grad():
        assert torch.equal(emb.embedding(table, ids.int()), table[ids])


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_kernel_route_only_under_the_kernel_impl(impl, monkeypatch):
    """A table the wrappers take for a CUDA one goes through the autograd
    Function under "kernel" and is plain indexing under "plain"."""
    taken = []
    monkeypatch.setattr(emb._build, "on_cpu", lambda x, what: False)
    monkeypatch.setattr(emb._Lookup, "apply", lambda table, ids: taken.append(1) or table[ids])
    table, ids = torch.arange(40.0).reshape(10, 4), torch.tensor([[3, 0, 0], [9, 1, 0]])
    with use_impl(impl):
        assert torch.equal(emb.embedding(table, ids), table[ids])
    assert taken == ([1] if impl == "kernel" else [])


def test_negative_ids_wrap_as_the_gather_does():
    """The backward's row for id -k is row V - k, where table[ids] read it:
    integer-valued fp32 gradients, so every sum is exact and the plain
    backward equals autograd's bit for bit."""
    gen = np.random.default_rng(9)
    v, d = 50, 8
    ids = torch.from_numpy(gen.integers(-v, v, (7, 30)))
    grad = torch.from_numpy(gen.integers(-8, 9, (7, 30, d)).astype(np.float32))
    table = torch.zeros(v, d, requires_grad=True)
    table[ids].backward(grad)
    assert torch.equal(emb.embedding_backward(ids, grad, v), table.grad)
    assert torch.equal(emb.embedding_backward(ids.int(), grad, v), table.grad)
    out, writes = _rehearse(ids.numpy(), grad.numpy(), v)
    assert (writes == 1).all() and torch.equal(torch.from_numpy(out), table.grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_plain_backward_within_one_ulp(dtype):
    gen = np.random.default_rng(4)
    ids = torch.from_numpy(clip_ids(gen, 12, vocab=500, eot=(8, 40)))
    grad = torch.from_numpy(gen.standard_normal((12, CLIP_T, 24)).astype(np.float32)).to(dtype)
    before = _embed_bwd()
    got = emb.embedding_backward(ids, grad, 500)
    assert got.dtype == dtype and got.shape == (500, 24)
    assert _embed_bwd() == before
    _assert_within_one_ulp(got, ids, grad, 500, chain=0)   # fp64 sums: one ulp alone
    absent = torch.ones(500, dtype=torch.bool)
    absent[ids.reshape(-1)] = False
    assert bool((got[absent] == 0).all())


@pytest.mark.parametrize("case", ["clip", "one_id", "distinct", "ends", "ragged"])
def test_kernel_order_rehearsed(case):
    """The kernel's bookkeeping: every row written once, and its sums within
    1 ulp (fp32 plus the accumulation bound) of the fp64 ones."""
    gen = np.random.default_rng(5)
    v, d = 700, 16
    ids = {"clip": lambda: clip_ids(gen, 30, vocab=v),
           "one_id": lambda: np.full(2000, 7),
           "distinct": lambda: gen.permutation(v)[:640],
           "ends": lambda: gen.choice([0, v - 1, 5], 1500),
           "ragged": lambda: gen.integers(0, 40, 1000)}[case]()
    grad = gen.standard_normal((*ids.shape, d)).astype(np.float32)
    out, writes = _rehearse(ids, grad, v)
    assert (writes == 1).all()
    _assert_within_one_ulp(torch.from_numpy(out), torch.from_numpy(ids), torch.from_numpy(grad), v)


@pytest.mark.parametrize("bad", ["float_ids", "table_3d", "width", "grad_shape", "grad_dtype",
                                 "rows"])
def test_bad_inputs_raise(bad):
    ids = torch.zeros(4, 5, dtype=torch.int64)
    grad = torch.zeros(4, 5, 16)
    table = torch.zeros(10, 16, requires_grad=True)
    call = {"float_ids": lambda: emb.embedding(table, ids.float()),
            "table_3d": lambda: emb.embedding(table[None], ids),
            "width": lambda: emb.embedding_backward(ids, torch.zeros(4, 5, 12), 10),
            "grad_shape": lambda: emb.embedding_backward(ids, torch.zeros(4, 6, 16), 10),
            "grad_dtype": lambda: emb.embedding_backward(ids, grad.double(), 10),
            "rows": lambda: emb.embedding_backward(ids, grad, 0)}[bad]
    with pytest.raises(ValueError):
        call()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


CARD_CASES = {   # name: (ids maker (gen) -> array, vocab, width)
    "clip_b504": (lambda gen: clip_ids(gen, 504), CLIP_V, 512),
    "clip_b108": (lambda gen: clip_ids(gen, 108), CLIP_V, 768),
    "one_id": (lambda gen: np.full(38808, 0), CLIP_V, 512),
    "distinct": (lambda gen: gen.permutation(CLIP_V)[:38808], CLIP_V, 512),
    "ends": (lambda gen: gen.choice([0, CLIP_V - 1], (300, CLIP_T)), CLIP_V, 512),
    "ragged": (lambda gen: gen.integers(0, 100, 1000 + 37), 1000, 264),
    "negative": (lambda gen: gen.integers(-CLIP_V, CLIP_V, (64, CLIP_T)), CLIP_V, 512),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_embedding_backward_kernel_on_card(case, dtype, cuda_device):
    make, v, d = CARD_CASES[case]
    gen = np.random.default_rng(6)
    ids = torch.from_numpy(make(gen)).to(cuda_device)
    grad = torch.from_numpy(gen.standard_normal((*ids.shape, d)).astype(np.float32)).to(
        cuda_device, dtype)
    before = _embed_bwd()
    got = emb.embedding_backward(ids, grad, v)
    again = emb.embedding_backward(ids.int(), grad, v)
    torch.cuda.synchronize()
    assert _embed_bwd() == before + 2
    assert got.dtype == dtype and got.shape == (v, d)
    assert torch.equal(got, again)   # bit-identical, int64 or int32 ids
    _assert_within_one_ulp(got, ids, grad, v)
    absent = torch.ones(v, dtype=torch.bool, device=cuda_device)
    absent[ids.reshape(-1)] = False
    assert bool((got[absent] == 0).all())


@pytest.mark.cuda
def test_embedding_backward_kernel_fp16_on_card(cuda_device):
    gen = np.random.default_rng(7)
    ids = torch.from_numpy(clip_ids(gen, 64)).to(cuda_device)
    grad = torch.from_numpy(gen.standard_normal((64, CLIP_T, 512)).astype(np.float32)).to(
        cuda_device, torch.float16)
    got = emb.embedding_backward(ids, grad, CLIP_V)
    _assert_within_one_ulp(got, ids, grad, CLIP_V)


@pytest.mark.cuda
def test_lookup_on_card_counts_one_backward(cuda_device):
    gen = np.random.default_rng(8)
    ids = torch.from_numpy(clip_ids(gen, 16)).to(cuda_device)
    table = torch.from_numpy(gen.standard_normal((CLIP_V, 512)).astype(np.float32)).to(
        cuda_device, torch.bfloat16).requires_grad_()
    g = torch.from_numpy(gen.standard_normal((16, CLIP_T, 512)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    before = _embed_bwd()
    out = emb.embedding(table, ids)
    assert torch.equal(out, table.detach()[ids])
    out.backward(g)
    torch.cuda.synchronize()
    assert _embed_bwd() == before + 1
    assert torch.equal(table.grad, emb.embedding_backward(ids, g, CLIP_V))
    _assert_within_one_ulp(table.grad, ids, g, CLIP_V)
    plain, direct = (table.detach().clone().requires_grad_() for _ in range(2))
    with use_impl("plain"):   # autograd's own backward, no launch of the kernel
        before = _embed_bwd()
        emb.embedding(plain, ids).backward(g)
        torch.cuda.synchronize()
    assert _embed_bwd() == before
    direct[ids].backward(g)
    assert torch.equal(plain.grad, direct.grad)
