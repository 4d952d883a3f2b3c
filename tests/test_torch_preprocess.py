"""PyTorch port, image preprocessing against the JAX package's preprocess_batch
and its golden (CPU, fp32), and the staged path: K6's plain version (the fused
uint8 normalize, which the wrapper runs on CPU tensors) against the Pallas
normalize kernel in interpret mode, and preprocess_staged against JAX's. K6
itself is held against its plain version on the card in
tests/test_torch_kernels.py."""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from construction_clip_tpu.data import preprocess as jpre
from construction_clip_tpu_torch.core import tracing
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


# ---------------------------------------------------------------- K6, staged

@pytest.fixture
def interpret_mode(monkeypatch):
    import functools

    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _u8(rng, shape):
    return (rng.random(shape) * 256).astype(np.uint8)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 32, 16, 3), (1, 7, 5, 3), (3, 24, 24, 3)])
def test_normalize_u8_plain_matches_pallas_interpret(shape, out_dtype, rng, interpret_mode):
    """K6's plain version against the Pallas normalize kernel in interpret
    mode: the same multiply by f32(1/255), subtract and multiply by f32(1/std)
    (1e-6 in fp32, where values reach ~2.2 and an ulp is 2.4e-7); in bf16 the
    one cast of those fp32 values, so equal."""
    from construction_clip_tpu.ops import pallas_preprocess

    from construction_clip_tpu_torch.ops.preprocess import normalize_u8_plain

    u8 = _u8(rng, shape)
    want = np.asarray(pallas_preprocess.normalize_u8.__wrapped__(
        jnp.asarray(u8), mean=jpre.CLIP_MEAN, std=jpre.CLIP_STD,
        out_dtype=getattr(jnp, out_dtype)).astype(jnp.float32))
    got = normalize_u8_plain(torch.from_numpy(u8), mean=pre.CLIP_MEAN, std=pre.CLIP_STD,
                             out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and tuple(got.shape) == shape
    if out_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    else:
        # a value one fp32 ulp from a bf16 tie can round either way: one bf16 step
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("view", ["strided", "offset"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_normalize_u8_plain_on_views_matches_pallas_interpret(view, out_dtype, rng,
                                                              interpret_mode):
    """K6's plain version on inputs the kernel's vector path does not take,
    against the Pallas kernel in interpret mode: every other pixel of a row
    (a non-contiguous view) and a view one byte into its storage (the
    misaligned case), each at a shape of 105 bytes, no multiple of 8 or 48
    (tolerances as above)."""
    from construction_clip_tpu.ops import pallas_preprocess

    from construction_clip_tpu_torch.ops.preprocess import normalize_u8_plain

    shape = (1, 7, 5, 3)
    if view == "strided":
        x = torch.from_numpy(_u8(rng, (1, 7, 10, 3)))[:, :, ::2]
        assert not x.is_contiguous()
    else:
        flat = torch.from_numpy(_u8(rng, (106,)))
        x = flat[1:].view(shape)
        assert x.storage_offset() == 1
    want = np.asarray(pallas_preprocess.normalize_u8.__wrapped__(
        jnp.asarray(x.contiguous().numpy()), mean=jpre.CLIP_MEAN, std=jpre.CLIP_STD,
        out_dtype=getattr(jnp, out_dtype)).astype(jnp.float32))
    got = normalize_u8_plain(x, mean=pre.CLIP_MEAN, std=pre.CLIP_STD,
                             out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and tuple(got.shape) == shape
    if out_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=0)


def test_normalize_u8_kernel_constants_are_cached_and_equal_constants():
    """The wrapper's cached kernel arguments: `_constants`' fp32 means and
    reciprocal stds, computed once per (mean, std)."""
    from construction_clip_tpu_torch.ops import preprocess as ops_pre

    ops_pre._kernel_constants.cache_clear()
    for mean, std in ((pre.CLIP_MEAN, pre.CLIP_STD), ((0.5, 0.4, 0.3), (0.2, 0.25, 0.3))):
        got = ops_pre._kernel_constants(tuple(mean), tuple(std))
        mean32, inv_std = ops_pre._constants(mean, std)
        assert all(isinstance(v, float) for v in got)
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      np.concatenate([mean32, inv_std]))
        assert np.array_equal(np.asarray(got, np.float64), np.asarray(got, np.float32))
        assert ops_pre._kernel_constants(tuple(mean), tuple(std)) is got
    info = ops_pre._kernel_constants.cache_info()
    assert (info.misses, info.hits) == (2, 2)
    with pytest.raises(ValueError, match="3 channel"):
        ops_pre._kernel_constants((0.5, 0.5), tuple(pre.CLIP_STD))


@pytest.mark.parametrize("mean_std", ["clip", "imagenet"])
def test_preprocess_staged_matches_jax(mean_std, rng):
    """preprocess_staged on the CPU runs K6's plain version; the JAX package's
    CPU path divides by 255 and by std where K6 multiplies by reciprocals: an
    ulp or so apart (1e-6 at values up to ~2.6)."""
    mean, std = ((jpre.CLIP_MEAN, jpre.CLIP_STD) if mean_std == "clip"
                 else (jpre.IMAGENET_MEAN, jpre.IMAGENET_STD))
    u8 = _u8(rng, (2, 32, 32, 3))
    want = np.asarray(jpre.preprocess_staged(jnp.asarray(u8), mean=mean, std=std))
    got = pre.preprocess_staged(u8, mean=mean, std=std)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    bf = pre.preprocess_staged(torch.from_numpy(u8), mean=mean, std=std,
                               out_dtype=torch.bfloat16)
    assert torch.equal(bf, got.to(torch.bfloat16))


def test_normalize_u8_wrapper_on_cpu_and_its_checks(rng):
    from construction_clip_tpu_torch.ops import preprocess as ops_pre

    u8 = torch.from_numpy(_u8(rng, (2, 6, 4, 3)))
    before = tracing.counters()
    got = ops_pre.normalize_u8(u8, mean=pre.CLIP_MEAN, std=pre.CLIP_STD)
    assert torch.equal(got, ops_pre.normalize_u8_plain(u8, mean=pre.CLIP_MEAN,
                                                       std=pre.CLIP_STD))
    assert tracing.counters() == before
    for bad in (u8.float(), u8[..., :2], u8[0]):
        with pytest.raises(ValueError, match="uint8"):
            ops_pre.normalize_u8(bad, mean=pre.CLIP_MEAN, std=pre.CLIP_STD)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops_pre.normalize_u8(u8, mean=pre.CLIP_MEAN, std=pre.CLIP_STD, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="3 channel"):
        ops_pre.normalize_u8(u8, mean=(0.5, 0.5), std=pre.CLIP_STD)
    with pytest.raises(ValueError):
        ops_pre.normalize_u8(u8.to("meta"), mean=pre.CLIP_MEAN, std=pre.CLIP_STD)


def test_inv_255_is_the_pallas_constant():
    from construction_clip_tpu_torch.ops.preprocess import INV_255

    assert np.float32(INV_255) == np.float32(1.0) / np.float32(255.0)
    assert INV_255 == float(jnp.asarray(1.0 / 255.0, jnp.float32))
