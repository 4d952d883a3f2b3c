"""PyTorch port, mT5 captioning against the JAX package (CPU, fp32, tiny sizes):
RMSNorm, the relative position buckets and biases, the encoder, the decoder
(teacher-forced and cached), greedy and sampled generation, the ClipCap prefix
encoder, the whole slice from images to caption tokens, and the port's
predict_t5 app end to end."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from construction_clip_tpu.core.configs import CLIPConfig as JCLIPConfig
from construction_clip_tpu.core.configs import ClipCapConfig as JClipCapConfig
from construction_clip_tpu.data.preprocess import preprocess_batch as j_preprocess
from construction_clip_tpu.infer import decode as jdecode
from construction_clip_tpu.infer.decode_t5 import t5_generate as j_generate
from construction_clip_tpu.infer.precompute import make_embed_classify_fn as j_embed_classify
from construction_clip_tpu.models import t5 as jt5
from construction_clip_tpu.models.clip import init_clip as j_init_clip
from construction_clip_tpu.models.clipcap import t5_model as jt5_model
from construction_clip_tpu.ops import norms as jnorms
from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.apps import predict_t5
from construction_clip_tpu_torch.core.configs import CLIPConfig, ClipCapConfig, T5Config
from construction_clip_tpu_torch.core.precision import BF16_POLICY, DEFAULT_POLICY
from construction_clip_tpu_torch.infer import decode
from construction_clip_tpu_torch.infer.decode_t5 import t5_generate
from construction_clip_tpu_torch.models import t5
from construction_clip_tpu_torch.models.clipcap import t5_model
from construction_clip_tpu_torch.ops.norms import rms_norm

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "t5_tiny.npz")
# fp32 through a 2+2-layer model: sums in another order than XLA's
TOL = dict(rtol=1e-4, atol=1e-5)
CFG = T5Config.tiny()


@pytest.fixture(scope="module")
def params():
    jparams = jt5.init_t5(jax.random.key(3), CFG)
    return jparams, convert.to_params(jparams).tree()


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rms_norm_matches_jax(dtype, rng):
    """HF's order (fp32 variance, cast, then scale) in fp32 and in bf16."""
    x = rng.standard_normal((3, 5, 32)).astype(np.float32) * 3
    s = rng.standard_normal(32).astype(np.float32)
    jx, js = jnp.asarray(x), jnp.asarray(s)
    tx, ts = _t(x), _t(s)
    if dtype == "bfloat16":
        jx, js = jx.astype(jnp.bfloat16), js.astype(jnp.bfloat16)
        tx, ts = tx.bfloat16(), ts.bfloat16()
    want = np.asarray(jnorms.rms_norm(jx, js).astype(jnp.float32))
    got = rms_norm(tx, ts).float().numpy()
    assert rms_norm(tx, ts).dtype == tx.dtype
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)   # one rounding of the same fp32 value
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_position_buckets_and_bias_are_exact(bidirectional, rng):
    rel = np.arange(-300, 301, dtype=np.int32)
    kw = dict(bidirectional=bidirectional, num_buckets=32, max_distance=128)
    want = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel), **kw))
    got = t5.relative_position_bucket(_t(rel), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    emb = rng.standard_normal((32, 2)).astype(np.float32)
    q_pos, k_pos = np.arange(5, 45, dtype=np.int32), np.arange(0, 300, dtype=np.int32)
    want = jt5.compute_position_bias(jnp.asarray(emb), jnp.asarray(q_pos), jnp.asarray(k_pos),
                                     CFG, bidirectional=bidirectional)
    got = t5.compute_position_bias(_t(emb), _t(q_pos), _t(k_pos), CFG,
                                   bidirectional=bidirectional)
    assert tuple(got.shape) == (1, 2, 40, 300)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _mask(b, t, lengths):
    m = np.zeros((b, t), np.int32)
    for i, n in enumerate(lengths):
        m[i, :n] = 1
    return m


def test_encode_with_padding_mask_matches_jax(params, rng):
    jparams, tparams = params
    ids = rng.integers(2, CFG.vocab_size, (3, 9)).astype(np.int32)
    mask = _mask(3, 9, [9, 6, 3])
    want = jt5.t5_encode(jparams, CFG, jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    got = t5.t5_encode(tparams, CFG, _t(ids), attention_mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_teacher_forced_decode_matches_jax(params, rng):
    jparams, tparams = params
    enc = rng.standard_normal((2, 7, CFG.d_model)).astype(np.float32)
    mask = _mask(2, 7, [7, 4])
    dec = rng.integers(0, CFG.vocab_size, (2, 6)).astype(np.int32)
    want, _ = jt5.t5_decode(jparams, CFG, jnp.asarray(dec), jnp.asarray(enc),
                            encoder_mask=jnp.asarray(mask))
    got, cache = t5.t5_decode(tparams, CFG, _t(dec), _t(enc), encoder_mask=_t(mask))
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_matches_jax_and_the_golden(params, rng):
    jparams, tparams = params
    ids = rng.integers(2, CFG.vocab_size, (2, 8)).astype(np.int32)
    mask = _mask(2, 8, [8, 5])
    dec = rng.integers(0, CFG.vocab_size, (2, 5)).astype(np.int32)
    want, want_enc = jt5.t5_forward(jparams, CFG, input_ids=jnp.asarray(ids),
                                    attention_mask=jnp.asarray(mask),
                                    decoder_input_ids=jnp.asarray(dec))
    got, got_enc = t5.t5_forward(tparams, CFG, input_ids=_t(ids), attention_mask=_t(mask),
                                 decoder_input_ids=_t(dec))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(want_enc), **TOL)
    # tests/test_goldens.py:test_t5_golden's inputs and params
    golden = convert.to_params(jt5.init_t5(jax.random.key(3), CFG)).tree()
    logits, _ = t5.t5_forward(golden, CFG, input_ids=torch.arange(2, 8)[None],
                              decoder_input_ids=torch.arange(1, 5)[None])
    np.testing.assert_allclose(logits[:, :, :32].numpy(), np.load(GOLDEN)["logits"], **TOL)


def test_cached_steps_equal_teacher_forced(params, rng):
    """One token at a time through the cache (written in place) gives the
    teacher-forced logits; the JAX cached step agrees too."""
    jparams, tparams = params
    enc = rng.standard_normal((2, 5, CFG.d_model)).astype(np.float32)
    mask = _mask(2, 5, [5, 3])
    dec = rng.integers(0, CFG.vocab_size, (2, 6)).astype(np.int32)
    full, _ = t5.t5_decode(tparams, CFG, _t(dec), _t(enc), encoder_mask=_t(mask))
    cache = t5.t5_init_cache(tparams, CFG, _t(enc), max_len=8)
    k_buffer = cache.k
    jcache = jt5.t5_init_cache(jparams, CFG, jnp.asarray(enc), max_len=8)
    for i in range(6):
        step, cache = t5.t5_decode(tparams, CFG, _t(dec[:, i:i + 1]), _t(enc),
                                   encoder_mask=_t(mask), cache=cache)
        jstep, jcache = jt5.t5_decode(jparams, CFG, jnp.asarray(dec[:, i:i + 1]),
                                      jnp.asarray(enc), encoder_mask=jnp.asarray(mask),
                                      cache=jcache)
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, i].numpy(), **TOL)
        np.testing.assert_allclose(step.numpy(), np.asarray(jstep), **TOL)
    assert cache.length == 6 and cache.k is k_buffer
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), **TOL)


def test_top_p_filter_gives_the_jax_mask(rng):
    logits = rng.standard_normal((4, 50)).astype(np.float32) * 3
    for top_p in (0.05, 0.5, 0.8, 0.95):
        want = np.asarray(jdecode._top_p_filter(jnp.asarray(logits), top_p))
        got = decode._top_p_filter(_t(logits), top_p).numpy()
        np.testing.assert_array_equal(got == decode.NEG_INF, want == jdecode.NEG_INF)
        np.testing.assert_array_equal(got, want)


def test_greedy_generate_is_token_exact_against_jax(params, rng):
    jparams, tparams = params
    enc = rng.standard_normal((3, 6, CFG.d_model)).astype(np.float32)
    mask = _mask(3, 6, [6, 4, 2])
    kw = dict(max_steps=10, eos_id=1, do_sample=False)
    want = j_generate(jparams, CFG, jnp.asarray(enc), encoder_mask=jnp.asarray(mask), **kw)
    got = t5_generate(tparams, CFG, _t(enc), encoder_mask=_t(mask), **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))


def test_greedy_generate_stops_at_eos_like_jax(params, rng):
    """An EOS id that greedy decoding reaches: the loop stops early, finished
    rows take token 0, and lengths count the EOS."""
    jparams, tparams = params
    enc = rng.standard_normal((2, 4, CFG.d_model)).astype(np.float32)
    probe = t5_generate(tparams, CFG, _t(enc), max_steps=6, eos_id=-1, do_sample=False)
    eos = int(probe.tokens[0, 2])
    kw = dict(max_steps=6, eos_id=eos, do_sample=False)
    want = j_generate(jparams, CFG, jnp.asarray(enc), **kw)
    got = t5_generate(tparams, CFG, _t(enc), **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert int(got.lengths[0]) <= 3


def test_sampling_is_reproducible_and_a_tiny_top_p_is_greedy(params, rng):
    _, tparams = params
    enc = _t(rng.standard_normal((3, 5, CFG.d_model)).astype(np.float32))

    def sample(seed, **kw):
        return t5_generate(tparams, CFG, enc, generator=torch.Generator().manual_seed(seed),
                           max_steps=12, eos_id=-1, **kw).tokens

    a, b = sample(5), sample(5)
    assert torch.equal(a, b)
    assert not torch.equal(a, sample(6))
    assert ((a >= 0) & (a < CFG.vocab_size)).all()
    greedy = t5_generate(tparams, CFG, enc, max_steps=12, eos_id=-1, do_sample=False).tokens
    assert torch.equal(sample(7, top_p=1e-6), greedy)


def test_bf16_generate_runs_with_the_policy(params, rng):
    """bf16 policy on fp32 params: the cache is bf16 and tokens are in range."""
    _, tparams = params
    enc = _t(rng.standard_normal((2, 5, CFG.d_model)).astype(np.float32)).bfloat16()
    cache = t5.t5_init_cache(tparams, CFG, enc, max_len=4, policy=BF16_POLICY)
    assert cache.k.dtype == torch.bfloat16 and cache.cross_k.dtype == torch.bfloat16
    res = t5_generate(tparams, CFG, enc, max_steps=4, do_sample=False, policy=BF16_POLICY)
    assert ((res.tokens >= 0) & (res.tokens < CFG.vocab_size)).all()


def test_init_t5_matches_the_jax_tree_shapes():
    ours = convert.init_t5(0, CFG)
    theirs = jt5.init_t5(jax.random.key(0), CFG)
    shapes = jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), theirs)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), ours) == shapes
    std = float(np.std(convert.init_t5(1, T5Config(vocab_size=512))["lm_head"]))
    assert abs(std - 512 ** -0.5) < 0.1 * 512 ** -0.5


# ------------------------------------------------------------ the whole slice

SLICE_CLIP = JCLIPConfig.tiny()
SLICE_CCFG = JClipCapConfig(prefix_length=3, attribute_length=0,
                            clip_dim=SLICE_CLIP.text.embed_dim)


class CharLMTok:
    """Stand-in tokenizer: one id per character, within the tiny T5 vocab."""

    def encode(self, text):
        return [ord(c) % 90 + 3 for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


class RandomClipTok:
    def tokenize(self, texts, ctx):
        rng = np.random.default_rng(len(texts))
        toks = rng.integers(1, SLICE_CLIP.text.vocab_size - 1, (len(texts), ctx))
        toks[:, -1] = SLICE_CLIP.text.vocab_size - 1   # EOT, the largest id
        return toks.astype(np.int32)


def test_slice_images_to_caption_tokens_matches_jax(rng):
    """uint8 images -> embed/classify -> attribute ids -> encode_with_prefix ->
    greedy generate: the port's app batch function gives JAX's tokens."""
    clip_params = j_init_clip(jax.random.key(0), SLICE_CLIP)
    cap_params = jt5_model.init_clipcap_t5(jax.random.key(1), SLICE_CCFG, CFG)
    staged = (rng.random((3, 40, 40, 3)) * 255).astype(np.uint8)
    clip_tok, lm_tok = RandomClipTok(), CharLMTok()
    ctx = SLICE_CLIP.text.context_length

    from construction_clip_tpu.data.labels import (
        CAPTION_TYPE_PROMPTS, VIOLATION_TYPES, attribute_string)
    emb, ct, vt = j_embed_classify(
        clip_params, SLICE_CLIP, clip_tok.tokenize(list(CAPTION_TYPE_PROMPTS), ctx),
        clip_tok.tokenize(list(VIOLATION_TYPES), ctx))(
            j_preprocess(staged, SLICE_CLIP.vision.image_size))
    attrs = [attribute_string(CAPTION_TYPE_PROMPTS[int(c)], VIOLATION_TYPES[int(v)])
             for c, v in zip(np.asarray(ct), np.asarray(vt))]
    ids = predict_t5.attribute_ids(lm_tok, attrs)
    hidden, mask = jt5_model.encode_with_prefix(
        cap_params, SLICE_CCFG, CFG, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray((ids != 0).astype(np.int32)), clip_embed=emb)
    want = j_generate(cap_params["t5"], CFG, hidden, encoder_mask=mask, max_steps=8,
                      do_sample=False)

    from construction_clip_tpu.data.schema import Annotation
    process = predict_t5.make_process(
        convert.to_params(clip_params), CLIPConfig.tiny(), convert.to_params(cap_params),
        ClipCapConfig(prefix_length=3, attribute_length=0, clip_dim=SLICE_CLIP.text.embed_dim),
        CFG, clip_tok, lm_tok, max_length=8, greedy=True, policy=DEFAULT_POLICY, device="cpu")
    records, got = process([Annotation(id=i, file_name=f"{i}.jpg") for i in range(3)], staged)
    assert [r["attribute"] for r in records] == attrs
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))

    # the prefix encoder on its own, against JAX
    thidden, tmask = t5_model.encode_with_prefix(
        convert.to_params(cap_params).tree(), SLICE_CCFG, CFG, input_ids=_t(ids),
        attention_mask=_t((ids != 0).astype(np.int32)), clip_embed=_t(np.asarray(emb)))
    np.testing.assert_allclose(thidden.numpy(), np.asarray(hidden), **TOL)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))


def test_clipcap_t5_forward_matches_jax(rng):
    cap_params = jt5_model.init_clipcap_t5(jax.random.key(2), SLICE_CCFG, CFG)
    ids = rng.integers(2, CFG.vocab_size, (2, 6)).astype(np.int32)
    mask = _mask(2, 6, [6, 4])
    emb = rng.standard_normal((2, SLICE_CCFG.clip_dim)).astype(np.float32)
    want = jt5_model.clipcap_t5_forward(cap_params, SLICE_CCFG, CFG, input_ids=jnp.asarray(ids),
                                        attention_mask=jnp.asarray(mask),
                                        clip_embed=jnp.asarray(emb))
    got = t5_model.clipcap_t5_forward(convert.to_params(cap_params), SLICE_CCFG, CFG,
                                      input_ids=_t(ids), attention_mask=_t(mask),
                                      clip_embed=_t(emb))
    assert tuple(got.shape) == (2, SLICE_CCFG.prefix_length + 6, CFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------------- the app

@pytest.fixture()
def corpus(tmp_path):
    """Tiny synthetic corpus on disk, and a `tokenizers` BPE JSON trained on its
    captions with the repo's own CLIs (as tests/test_cli_apps.py builds them)."""
    import subprocess
    import sys

    from PIL import Image

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rng = np.random.default_rng(0)
    anns = []
    for i in range(5):
        fn = f"img_{i}.jpg"
        Image.fromarray((rng.random((96, 128, 3)) * 255).astype(np.uint8)).save(tmp_path / fn)
        anns.append({"id": i, "caption_type": "violation" if i % 2 else "status",
                     "violation_type": ["墜落", "機械", "物料"][i % 3],
                     "violation_list": f"示例缺失{i}", "caption": f"示例說明{i}",
                     "file_name": fn, "objects": ""})
    json_path = tmp_path / "test.json"
    json_path.write_text(json.dumps({"type": "captions", "annotations": anns},
                                    ensure_ascii=False), encoding="utf-8")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo)
    txt, tok = str(tmp_path / "text.txt"), str(tmp_path / "bpe.json")
    for argv in (["json_to_text.py", "--json_path", str(json_path), "--out", txt],
                 ["train_tokenizer.py", "--input", txt, "--out", tok, "--vocab_size", "300"]):
        r = subprocess.run([sys.executable, os.path.join(repo, "apps", argv[0]), *argv[1:]],
                           capture_output=True, text=True, timeout=120, env=env)
        assert r.returncode == 0, r.stderr
    return tmp_path, str(json_path), tok


def test_predict_t5_app_writes_one_caption_per_image(corpus, tmp_path, capsys):
    import gzip

    root, json_path, tok = corpus
    merges = tmp_path / "merges.txt.gz"
    with gzip.open(merges, "wt", encoding="utf-8") as f:
        f.write("version\na b\n")
    out = str(tmp_path / "out" / "output_t5.json")
    # tiny_bpe: tiny's towers with a text vocab that a BPE merges file fits
    predict_t5.main(["--json_path", json_path, "--image_root", str(root), "--arch", "tiny_bpe",
                     "--clip_bpe", str(merges), "--tokenizer", tok, "--t5_size", "tiny",
                     "--prefix_length", "4", "--max_length", "6", "--batch_size", "2",
                     "--out", out, "--device", "cpu"])
    results = json.loads(open(out, encoding="utf-8").read())
    assert [r["id"] for r in results] == list(range(5))
    for r in results:
        assert set(r) == {"id", "file_name", "attribute", "caption", "ground_truth_caption"}
        assert isinstance(r["caption"], str) and r["attribute"]
    assert "wrote" in capsys.readouterr().out
