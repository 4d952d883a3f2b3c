"""PyTorch port: what the SIMT routes of K1, K7 and K9 run, decided on the host.

K9's fp32 products run on csrc/gemm_f32.cuh and its bf16 products at widths
off the tensor cores on csrc/gemm.cuh (`ops/mlp.gemm_route`); K7's gate admits
the shapes it admitted when its attention pass was one warp a query row, at
the shapes of K1's gate test (`tests/test_torch_attention_block.py`)."""

import pytest
import torch

from construction_clip_tpu_torch.ops import attention_block as fab
from construction_clip_tpu_torch.ops import attention_block_int8 as fab8
from construction_clip_tpu_torch.ops import mlp


@pytest.mark.parametrize("dtype, d, hidden, want", [
    (torch.float32, 768, 3072, "gemm_f32"),    # ViT-B/32's MLP in fp32
    (torch.float32, 512, 2048, "gemm_f32"),    # the text tower's
    (torch.float32, 18, 70, "gemm_f32"),       # rows of 72 bytes: the scalar producer
    (torch.bfloat16, 768, 3072, "gemm_tc"),
    (torch.bfloat16, 40, 100, "block_gemm"),   # a hidden width off the tensor cores
    (torch.bfloat16, 44, 176, "block_gemm")])
def test_mlp_products_run_on_the_gemm_of_their_route(dtype, d, hidden, want):
    assert mlp.gemm_route(dtype, d, hidden) == want
    assert mlp.route(dtype, d, hidden) == ("tc" if want == "gemm_tc" else "simt")


# (B, T, D, heads, K1's verdict, K7's verdict): K1's gate test's shapes. K7's
# gate has no head-width bound of its own (one row of 4 D bytes in shared
# memory, T <= 256 and the attention budget), so it takes dh 129 where K1's
# register tiles do not.
GATE_CASES = [(8, 50, 768, 12, True, True), (16, 50, 768, 12, True, True),
              (9, 77, 512, 8, True, True), (2, 77, 512, 8, True, True),
              (36, 50, 768, 12, True, True), (36, 77, 512, 8, True, True),
              (9, 77, 768, 12, True, True), (16, 30, 768, 8, True, True),
              (1, 256, 512, 8, True, True), (1, 257, 512, 8, False, False),
              (2, 5, 128, 1, True, True), (2, 5, 129, 1, False, True),
              (1, 256, 110, 1, True, True), (1, 256, 111, 1, False, False),
              (2, 7, 18, 2, True, True), (2, 5, 16, 1, True, True), (3, 77, 36, 1, True, True)]


@pytest.mark.parametrize("b, t, d, heads, k1, k7", GATE_CASES)
def test_int8_block_gate_is_unchanged(b, t, d, heads, k1, k7):
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(b, t, d, dtype=dtype)
        assert fab.supported(x, heads) == k1
        assert fab8.supported(x, heads) == k7
    assert fab8.route(torch.float32, d // heads) == "simt"
    assert fab8.route(torch.bfloat16, d // heads) == ("tc" if d // heads == 64 else "simt")
