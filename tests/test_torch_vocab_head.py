"""PyTorch port, the vocab-head GEMV (ops/vocab_head.py, kernel K8 on the card)
and the int8 T5 head against the JAX package on the CPU: the plain version
against the Pallas kernel run in interpret mode, int8 quantization bit for bit,
the head's routing in models/t5._head_logits, and the quantized head kept out
of the precision casts."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from construction_clip_tpu.models import t5 as jt5
from construction_clip_tpu.ops import pallas_vocab_head as jvh
from construction_clip_tpu.ops import quant as jquant
from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.core.configs import T5Config
from construction_clip_tpu_torch.core.params import as_tree
from construction_clip_tpu_torch.core.precision import BF16_POLICY
from construction_clip_tpu_torch.models import t5
from construction_clip_tpu_torch.ops import vocab_head as vh
from construction_clip_tpu_torch.ops.attention import use_impl
from construction_clip_tpu_torch.ops.quant import quantize_weight

D, V = 64, 384   # V a multiple of 128: the Pallas kernel's tile rule


def _table(rng, int8: bool):
    w = rng.standard_normal((D, V)).astype(np.float32) * 0.05
    if not int8:
        return jnp.asarray(w, jnp.bfloat16), None
    q, s = jquant.quantize_weight(jnp.asarray(w), axis=0)
    return q, s


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_plain_version_matches_the_pallas_kernel(rows, int8, rng):
    """Same rounding points: x to bf16, fp32 sums, the scale after the sum,
    fp32 logits. 1e-5: fp32 summation order only."""
    table, scale = _table(rng, int8)
    x = rng.standard_normal((rows, D)).astype(np.float32)
    want = jvh.vocab_head_logits(jnp.asarray(x), table, scale, interpret=True)
    t_table = torch.from_numpy(np.array(table.astype(jnp.float32))).to(
        torch.int8 if int8 else torch.bfloat16)
    t_scale = torch.from_numpy(np.array(scale)) if int8 else None
    got = vh.vocab_head_logits_plain(torch.from_numpy(x), t_table, t_scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_quantize_weight_is_bit_equal_to_jax(rng):
    w = rng.standard_normal((D, 40)).astype(np.float32) * 0.3
    w[:, 7] = 0.0   # an all-zero column takes scale 1
    for axis in (0, 1):
        jq, js = jquant.quantize_weight(jnp.asarray(w), axis=axis)
        q, s = quantize_weight(torch.from_numpy(w), axis=axis)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_supported_keeps_the_small_batch_and_dtype_rules():
    bf16 = torch.zeros(D, 385, dtype=torch.bfloat16)   # any V: no TPU tile rule
    assert vh.supported(vh.MAX_ROWS, bf16) and vh.MAX_ROWS == jvh.MAX_ROWS
    assert not vh.supported(vh.MAX_ROWS + 1, bf16)
    assert vh.supported(1, torch.zeros(D, V, dtype=torch.int8))
    assert not vh.supported(1, torch.zeros(D, V))
    assert not vh.supported(1, torch.zeros(D, V, 1, dtype=torch.bfloat16))


def test_cpu_wrapper_takes_the_plain_version_and_checks_its_arguments(rng):
    table = torch.from_numpy(rng.standard_normal((D, 100)).astype(np.float32)).bfloat16()
    x = torch.from_numpy(rng.standard_normal((2, D)).astype(np.float32))
    before = tracing.counters()
    assert torch.equal(vh.vocab_head_logits(x, table), vh.vocab_head_logits_plain(x, table))
    assert tracing.counters() == before
    with pytest.raises(ValueError, match="scale"):
        vh.vocab_head_logits(x, table.to(torch.int8))
    with pytest.raises(ValueError, match="scale"):
        vh.vocab_head_logits(x, table, torch.ones(100))
    with pytest.raises(ValueError, match="fit"):
        vh.vocab_head_logits(x[:, :-1], table)
    with pytest.raises(ValueError, match="bf16 or int8"):
        vh.vocab_head_logits(x, table.float())


def test_head_logits_routes_small_cached_steps_to_the_gemv(rng, monkeypatch):
    """Cached one-token steps at B <= 8 with a bf16 or int8 table go to the
    vocab-head function; B > 8, an uncached call or an fp32 table take the
    plain GEMM. Logits are sliced to the vocab either way."""
    calls = []
    real = vh.vocab_head_logits

    def recording(x, table, scale=None):
        calls.append(x.shape[0])
        return real(x, table, scale)

    monkeypatch.setattr(vh, "vocab_head_logits", recording)
    w = rng.standard_normal((D, 300)).astype(np.float32) * 0.05
    bf16 = torch.from_numpy(w).bfloat16()
    q, s = quantize_weight(bf16, axis=0)
    for b, head, cached, routed in [(8, bf16, True, True), (9, bf16, True, False),
                                    (3, bf16, False, False), (1, {"q": q, "s": s}, True, True),
                                    (12, {"q": q, "s": s}, True, False),
                                    (2, bf16.float(), True, False)]:
        dtype = torch.float32 if not isinstance(head, dict) and head.dtype == torch.float32 \
            else torch.bfloat16
        x = torch.from_numpy(rng.standard_normal((b, 1, D)).astype(np.float32)).to(dtype)
        calls.clear()
        got = t5._head_logits(head, x, 250, cached_step=cached)
        assert calls == ([b] if routed else []), (b, cached)
        assert tuple(got.shape) == (b, 1, 250) and got.dtype == torch.float32
    with use_impl("plain"):
        calls.clear()
        got = t5._head_logits(bf16, x.bfloat16()[:2], 250, cached_step=True)
        assert calls == []
        want = vh.vocab_head_logits_plain(x.bfloat16()[:2, 0], bf16)[:, None, :250]
        assert torch.equal(got, want)


def test_plain_gemm_head_matches_jax_above_the_gate(rng):
    """B > 8: the head is x @ table in the compute dtype, then fp32 (the int8
    table dequantized in the epilogue), as XLA computes it in JAX. Both round
    the product to bf16: one bf16 step apart at most."""
    w = rng.standard_normal((D, V)).astype(np.float32) * 0.05
    x = rng.standard_normal((12, 1, D)).astype(np.float32)
    jw, jx = jnp.asarray(w, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)
    jq, js = jquant.quantize_weight(jw, axis=0)
    tw, tx = torch.from_numpy(w).bfloat16(), torch.from_numpy(x).bfloat16()
    for jhead, thead in [(jw, tw), ({"q": jq, "s": js},
                                    {"q": torch.from_numpy(np.array(jq)),
                                     "s": torch.from_numpy(np.array(js))})]:
        want = jt5._head_logits(jhead, jx, 300, cached_step=True)
        got = t5._head_logits(thead, tx, 300, cached_step=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-2, atol=1e-2)


def test_int8_head_survives_the_casts_and_tracks_the_bf16_head(rng):
    cfg = T5Config.tiny()
    tree = convert.init_t5(0, cfg)
    params = as_tree(convert.to_params(tree, dtype=torch.bfloat16))
    qparams = t5.quantize_t5_head(params)
    cast = t5._cast_params(qparams, BF16_POLICY)
    assert cast["lm_head"]["q"].dtype == torch.int8
    assert cast["lm_head"]["s"].dtype == torch.float32
    assert cast["shared"].dtype == torch.bfloat16
    # to_params keeps a quantized leaf's scale in fp32 whatever dtype asks
    carried = convert.to_params(dict(tree, lm_head={"q": qparams["lm_head"]["q"].numpy(),
                                                    "s": qparams["lm_head"]["s"].numpy()}),
                                dtype=torch.bfloat16).tree()
    assert carried["lm_head"]["s"].dtype == torch.float32
    assert torch.equal(carried["lm_head"]["s"], qparams["lm_head"]["s"])
    assert carried["lm_head"]["q"].dtype == torch.int8 and carried["shared"].dtype == torch.bfloat16

    enc = torch.from_numpy(rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32))
    logits = {}
    for name, p in (("bf16", params), ("int8", qparams)):
        cache = t5.t5_init_cache(p, cfg, enc, max_len=3, policy=BF16_POLICY)
        out, cache = t5.t5_decode(p, cfg, torch.zeros(2, 1, dtype=torch.int32), enc,
                                  cache=cache, policy=BF16_POLICY)
        logits[name] = out
        assert tuple(out.shape) == (2, 1, cfg.vocab_size) and torch.isfinite(out).all()
    # int8 weight quantization error only
    err = (logits["int8"] - logits["bf16"]).abs().max() / logits["bf16"].abs().max()
    assert float(err) < 0.05
