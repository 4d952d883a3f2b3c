"""PyTorch port, image preprocessing against the JAX package's preprocess_batch
and its golden (CPU, fp32)."""

import os

import numpy as np
import pytest

import torch

from construction_clip_tpu.data import preprocess as jpre
from construction_clip_tpu_torch.data import preprocess as pre

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "preprocess.npz")
# the resize is two fp32 GEMMs whose sums run in another order than XLA's;
# outputs are normalized values of magnitude <= ~2.2
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(48, 64), (64, 48), (40, 40), (33, 97)])
def test_matches_jax_preprocess_batch(hw, rng):
    u8 = (rng.random((2, *hw, 3)) * 255).astype(np.uint8)
    want = np.asarray(jpre.preprocess_batch(u8, 32))
    got = pre.preprocess_batch(u8, 32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_matches_golden():
    yy, xx = np.mgrid[0:60, 0:80]
    img = np.stack([xx % 256, yy % 256, (xx * yy) % 256], -1).astype(np.uint8)
    got = pre.preprocess_batch(img[None], 32)
    np.testing.assert_allclose(got.numpy(), np.load(GOLDEN)["out"], **TOL)


@pytest.mark.parametrize("sizes", [(256, 224), (60, 32), (17, 40)])
def test_resize_weights_are_the_jax_weights(sizes):
    w = pre._pil_resize_weights(*sizes)
    np.testing.assert_array_equal(w, jpre._pil_resize_weights(*sizes))
    np.testing.assert_allclose(w.sum(axis=1), 1.0, rtol=1e-6)


def test_center_crop_rounds_odd_margin():
    img = torch.arange(11 * 6 * 1, dtype=torch.float32).reshape(11, 6, 1)
    got = pre.center_crop(img, 4)  # margins 7 and 2: top int(round(3.5)) = 4
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpre.center_crop(img.numpy(), 4)))
