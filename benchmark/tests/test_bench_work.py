"""The work functions against hand-worked cases at the cells' shapes."""

import pytest

from peaks import bound_s
from work import k1, k3, k4, k5, model


def test_k1_fp32_zeroshot_shape():
    # [32, 50, 768], 12 heads, fp32: M = 1600 rows;
    # products 2*1600*768*3072 = 7,549,747,200, attention 4*32*12*2500*64 = 245,760,000;
    # bytes: x and out 2*1600*768 = 2,457,600, weights 4*768^2 = 2,359,296, LN and
    # biases 6*768 = 4,608: 4,821,504 elements of 4 bytes
    ops, moved = k1.work(32, 50, 768, 12, False, 4)
    assert ops == 7_795_507_200
    assert moved == 19_286_016
    assert bound_s(ops, moved, "fp32") == pytest.approx(7_795_507_200 / 67e12)


def test_k1_k3_bf16_train_shapes():
    # image tower [504, 50, 768], 12 heads: K3 products 2*25200*768*5376 =
    # 208,089,907,200 and six attention products 12*504*12*2500*64 = 11,612,160,000
    ops, moved = k3.work(504, 50, 768, 12, False, 2)
    assert ops == 219_702_067_200
    # inputs x, g (2*25200*768), weights 4*768^2, LN and biases 6*768 (less b_out: 5*768
    # with the 3*768 of b_qkv), outputs dx, dqkv, merged 5*25200*768, fp32 LN grads 2*768*4
    assert moved == 2 * (2 * 25200 * 768 + 2 * 768 + 3 * 768 ** 2 + 3 * 768 + 768 ** 2) \
        + 2 * 5 * 25200 * 768 + 8 * 768
    # text tower [504, 77, 512], 8 heads, causal: 77*78/2 = 3003 kept pairs;
    # products 2*38808*512*2048 = 81,386,274,816, attention 4*504*8*3003*64 = 3,099,672,576
    ops, _ = k1.work(504, 77, 512, 8, True, 2)
    assert ops == 84_485_947_392


def test_k4_k5_bf16_vitl14_shape():
    # [108, 16, 257, 64]: 257^2 = 66,049 pairs a head
    ops, moved = k4.work(108, 16, 257, 64, False, 2)
    assert ops == 29_217_964_032          # 4*108*16*66049*64
    assert moved == 227_377_152           # q, k, v, o: 4*108*16*257*64 elements of 2 bytes
    ops, moved = k5.work(108, 16, 257, 64, False, 2)
    assert ops == 73_044_910_080          # 10*108*16*66049*64
    assert moved == 397_910_016           # q, k, v, dO, dq, dk, dv
    # memory-bound at this shape on the data sheet's rates
    assert bound_s(*k4.work(108, 16, 257, 64, False, 2), "bf16") == \
        pytest.approx(227_377_152 / 3.35e12)


def test_model_flops_vit_b_32():
    cfg = {"vision": {"image_size": 224, "patch_size": 32, "width": 768, "layers": 12,
                      "heads": 12, "embed_dim": 512},
           "text": {"vocab_size": 49408, "context_length": 77, "width": 512, "layers": 12,
                    "heads": 8, "embed_dim": 512}}
    # patches 2*49*3072*768 = 231,211,008; 12 layers of 2*50*12*768^2 + 4*50^2*768 =
    # 715,468,800; projection 2*768*512 = 786,432
    assert model.vision_forward(cfg) == 8_817_623_040
    # 12 layers of 2*77*12*512^2 + 4*77^2*512 = 484,442,112 + 12,142,592; projection 524,288
    assert model.text_forward(cfg) == 5_959_540_736
    assert model.zeroshot_batch(cfg, 32, 9) == 32 * 8_817_623_040 + 2 * 32 * 9 * 512
    assert model.train_step(cfg, 504) == 3 * (504 * (8_817_623_040 + 5_959_540_736)
                                              + 2 * 504 * 504 * 512)
