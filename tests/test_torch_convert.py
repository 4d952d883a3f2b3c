"""PyTorch port, the pretrained-weight converters against the JAX package's (CPU):
OpenAI and HF CLIP, HF GPT-2 and HF mT5 state dicts into the port's numpy tree,
equal leaf for leaf (atol 0) to the JAX converters' trees; the port's models on
the converted trees against the HF models; `load_torch_checkpoint`'s pickle
gate; and the apps that read .pt files (`load_clip`, train_clipcap
--gpt_checkpoint, train_clipcap_t5 --t5_checkpoint, export_embeddings).

No weights are downloaded: the HF models are made from local tiny configs with
random weights, and the OpenAI layout is built from its key names."""

import contextlib
import importlib.util
import io
import os
import runpy
import sys

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from construction_clip_tpu_torch import convert  # noqa: E402
from construction_clip_tpu_torch.core.configs import (  # noqa: E402
    CLIPConfig, ClipCapConfig, GPT2Config, T5Config)
from construction_clip_tpu_torch.models import gpt2, t5  # noqa: E402
from construction_clip_tpu_torch.models.clip import convert as clip_convert  # noqa: E402
from construction_clip_tpu_torch.models.clip.model import encode_image, encode_text  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP_CFG = CLIPConfig.tiny()
GCFG = GPT2Config.tiny()
TCFG = T5Config.tiny()


@pytest.fixture(scope="module")
def hf_clip():
    v, t = CLIP_CFG.vision, CLIP_CFG.text
    cfg = transformers.CLIPConfig(
        vision_config=dict(image_size=v.image_size, patch_size=v.patch_size,
                           hidden_size=v.width, num_hidden_layers=v.layers,
                           num_attention_heads=v.heads, intermediate_size=4 * v.width,
                           hidden_act="quick_gelu", projection_dim=v.embed_dim),
        text_config=dict(vocab_size=t.vocab_size, hidden_size=t.width,
                         num_hidden_layers=t.layers, num_attention_heads=t.heads,
                         intermediate_size=4 * t.width,
                         max_position_embeddings=t.context_length,
                         hidden_act="quick_gelu", projection_dim=t.embed_dim),
        projection_dim=v.embed_dim)
    torch.manual_seed(0)
    return transformers.CLIPModel(cfg).eval()


@pytest.fixture(scope="module")
def hf_gpt2():
    cfg = transformers.GPT2Config(vocab_size=GCFG.vocab_size, n_positions=GCFG.n_positions,
                                  n_embd=GCFG.n_embd, n_layer=GCFG.n_layer,
                                  n_head=GCFG.n_head, resid_pdrop=0.0, embd_pdrop=0.0,
                                  attn_pdrop=0.0)
    torch.manual_seed(1)
    return transformers.GPT2LMHeadModel(cfg).eval()


@pytest.fixture(scope="module")
def hf_mt5():
    cfg = transformers.MT5Config(
        vocab_size=TCFG.vocab_size, d_model=TCFG.d_model, d_kv=TCFG.d_kv, d_ff=TCFG.d_ff,
        num_layers=TCFG.num_layers, num_decoder_layers=TCFG.num_decoder_layers,
        num_heads=TCFG.num_heads, tie_word_embeddings=False, dropout_rate=0.0)
    torch.manual_seed(2)
    return transformers.MT5ForConditionalGeneration(cfg).eval()


def _sd(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _openai_sd(hf_clip) -> dict:
    """The HF CLIP's tensors renamed into OpenAI `clip`'s state-dict layout."""
    sd = _sd(hf_clip)
    out = {
        "visual.conv1.weight": sd["vision_model.embeddings.patch_embedding.weight"],
        "visual.class_embedding": sd["vision_model.embeddings.class_embedding"],
        "visual.positional_embedding": sd["vision_model.embeddings.position_embedding.weight"],
        "visual.ln_pre.weight": sd["vision_model.pre_layrnorm.weight"],
        "visual.ln_pre.bias": sd["vision_model.pre_layrnorm.bias"],
        "visual.ln_post.weight": sd["vision_model.post_layernorm.weight"],
        "visual.ln_post.bias": sd["vision_model.post_layernorm.bias"],
        "visual.proj": sd["visual_projection.weight"].T.copy(),
        "token_embedding.weight": sd["text_model.embeddings.token_embedding.weight"],
        "positional_embedding": sd["text_model.embeddings.position_embedding.weight"],
        "ln_final.weight": sd["text_model.final_layer_norm.weight"],
        "ln_final.bias": sd["text_model.final_layer_norm.bias"],
        "text_projection": sd["text_projection.weight"].T.copy(),
        "logit_scale": sd["logit_scale"],
    }
    for hf_prefix, oa_prefix, n in (
            ("vision_model.encoder.layers", "visual.transformer.resblocks", CLIP_CFG.vision.layers),
            ("text_model.encoder.layers", "transformer.resblocks", CLIP_CFG.text.layers)):
        for i in range(n):
            hp, op = f"{hf_prefix}.{i}", f"{oa_prefix}.{i}"
            out[f"{op}.attn.in_proj_weight"] = np.concatenate(
                [sd[f"{hp}.self_attn.{x}_proj.weight"] for x in "qkv"], 0)
            out[f"{op}.attn.in_proj_bias"] = np.concatenate(
                [sd[f"{hp}.self_attn.{x}_proj.bias"] for x in "qkv"])
            for name in ("weight", "bias"):
                out[f"{op}.attn.out_proj.{name}"] = sd[f"{hp}.self_attn.out_proj.{name}"]
                out[f"{op}.ln_1.{name}"] = sd[f"{hp}.layer_norm1.{name}"]
                out[f"{op}.ln_2.{name}"] = sd[f"{hp}.layer_norm2.{name}"]
                out[f"{op}.mlp.c_fc.{name}"] = sd[f"{hp}.mlp.fc1.{name}"]
                out[f"{op}.mlp.c_proj.{name}"] = sd[f"{hp}.mlp.fc2.{name}"]
    return out


def _assert_trees_equal(got, want, path=""):
    """Same keys, and every leaf the same dtype, shape and values (atol 0)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    assert isinstance(got, np.ndarray), path
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=path)


def _jcfg_dict(cfg):
    import dataclasses

    return dataclasses.asdict(cfg)


# ---- each converter against the JAX package's ---------------------------------------------

def test_clip_hf_converter_gives_the_jax_tree(hf_clip):
    from construction_clip_tpu.core.configs import CLIPConfig as JCLIPConfig
    from construction_clip_tpu.models.clip import convert as jconvert

    sd = _sd(hf_clip)
    want = jconvert.from_hf_state_dict(sd, JCLIPConfig.tiny())
    _assert_trees_equal(clip_convert.from_hf_state_dict(sd, CLIP_CFG), want)


def test_clip_openai_converter_gives_the_jax_tree_and_config(hf_clip):
    """The OpenAI layout's tree and the config read from it (width // 64
    heads, as the JAX converter reads it) equal the JAX converter's; with the
    config given, the tree equals the HF converter's of the same tensors."""
    from construction_clip_tpu.models.clip import convert as jconvert

    sd = _openai_sd(hf_clip)
    want, want_cfg = jconvert.from_openai_state_dict(sd)
    got, got_cfg = clip_convert.from_openai_state_dict(sd)
    _assert_trees_equal(got, want)
    assert _jcfg_dict(got_cfg) == _jcfg_dict(want_cfg)
    assert got_cfg.vision.width == CLIP_CFG.vision.width and got_cfg.text.layers == 2
    given, _ = clip_convert.from_openai_state_dict(sd, CLIP_CFG)
    _assert_trees_equal(given, clip_convert.from_hf_state_dict(_sd(hf_clip), CLIP_CFG))


def test_gpt2_converter_gives_the_jax_tree(hf_gpt2):
    """With and without the `transformer.` prefix of GPT2LMHeadModel."""
    from construction_clip_tpu.core.configs import GPT2Config as JGPT2Config
    from construction_clip_tpu.models import gpt2 as jgpt2

    sd = _sd(hf_gpt2)
    bare = {k[len("transformer."):]: v for k, v in sd.items() if k.startswith("transformer.")}
    for state in (sd, bare):
        want = jgpt2.from_hf_state_dict(state, JGPT2Config.tiny())
        _assert_trees_equal(gpt2.from_hf_state_dict(state, GCFG), want)


def test_t5_converter_gives_the_jax_tree(hf_mt5):
    """The untied mT5 head, and a tied checkpoint without lm_head.weight."""
    from construction_clip_tpu.core.configs import T5Config as JT5Config
    from construction_clip_tpu.models import t5 as jt5

    sd = _sd(hf_mt5)
    tied = {k: v for k, v in sd.items() if k != "lm_head.weight"}
    for state in (sd, tied):
        want = jt5.from_hf_state_dict(state, JT5Config.tiny())
        _assert_trees_equal(t5.from_hf_state_dict(state, TCFG), want)


# ---- the port's models on the converted trees against HF's --------------------------------

def test_mt5_logits_on_the_converted_tree_match_hf(hf_mt5, rng):
    """t5_forward on the converted tree against MT5ForConditionalGeneration's
    logits, fp32, rtol/atol 1e-5 (a 2+2-layer model: the sums in another
    order); rows with padding in the encoder's attention mask."""
    ids = rng.integers(2, TCFG.vocab_size, (3, 7)).astype(np.int64)
    ids[1, 5:] = 0
    mask = (ids != 0).astype(np.int64)
    dec = rng.integers(2, TCFG.vocab_size, (3, 5)).astype(np.int64)
    dec[:, 0] = 0
    with torch.no_grad():
        want = hf_mt5(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                      decoder_input_ids=torch.from_numpy(dec)).logits
    params = convert.to_params(t5.from_hf_state_dict(_sd(hf_mt5), TCFG)).tree()
    got, _ = t5.t5_forward(params, TCFG, input_ids=torch.from_numpy(ids),
                           decoder_input_ids=torch.from_numpy(dec),
                           attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_gpt2_logits_on_the_converted_tree_match_hf(hf_gpt2, rng):
    """gpt2_forward on the converted tree against GPT2LMHeadModel's logits,
    fp32, rtol/atol 1e-5."""
    tokens = rng.integers(0, GCFG.vocab_size, (2, 9)).astype(np.int64)
    with torch.no_grad():
        want = hf_gpt2(input_ids=torch.from_numpy(tokens)).logits
    params = convert.to_params(gpt2.from_hf_state_dict(_sd(hf_gpt2), GCFG)).tree()
    got, _ = gpt2.gpt2_forward(params, GCFG, tokens=torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_clip_features_on_the_converted_tree_match_hf(hf_clip, rng):
    """encode_image and encode_text on the HF converter's tree against
    CLIPModel's features, fp32, rtol 2e-4 / atol 2e-5 (as the JAX package's
    parity test holds its own)."""
    imgs = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    toks = np.zeros((2, CLIP_CFG.text.context_length), np.int64)
    for b, n in enumerate((4, 7)):
        toks[b, 0], toks[b, 1:n], toks[b, n] = 254, rng.integers(3, 200, n - 1), 255
    with torch.no_grad():
        want_img = hf_clip.get_image_features(
            pixel_values=torch.from_numpy(imgs).permute(0, 3, 1, 2))
        hidden = hf_clip.text_model(input_ids=torch.from_numpy(toks)).last_hidden_state
        want_txt = hidden[torch.arange(2), torch.from_numpy(toks).argmax(-1)] @ \
            hf_clip.text_projection.weight.T
    params = convert.to_params(clip_convert.from_hf_state_dict(_sd(hf_clip), CLIP_CFG)).tree()
    got_img = encode_image(params, CLIP_CFG, torch.from_numpy(imgs))
    got_txt = encode_text(params, CLIP_CFG, torch.from_numpy(toks))
    np.testing.assert_allclose(got_img.numpy(), want_img.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_txt.numpy(), want_txt.numpy(), rtol=2e-4, atol=2e-5)


# ---- the .pt reader and the apps ------------------------------------------------------------

def _jax_common():
    spec = importlib.util.spec_from_file_location("jax_apps_common",
                                                  os.path.join(REPO, "apps", "common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_load_torch_checkpoint_reads_state_dicts_and_gates_pickles(hf_gpt2, tmp_path,
                                                                   monkeypatch):
    """A plain state dict loads as numpy with weights_only; a pickled Module
    is refused with the CCTPU_UNSAFE_PICKLE hint unless that variable is 1,
    and then gives its state dict: both as the JAX package's loader."""
    from construction_clip_tpu.models.clip import convert as jconvert

    plain, module = str(tmp_path / "sd.pt"), str(tmp_path / "module.pt")
    torch.save(hf_gpt2.state_dict(), plain)
    torch.save(hf_gpt2, module)
    monkeypatch.delenv("CCTPU_UNSAFE_PICKLE", raising=False)
    got = clip_convert.load_torch_checkpoint(plain)
    _assert_trees_equal(got, jconvert.load_torch_checkpoint(plain))
    assert sorted(got) == sorted(hf_gpt2.state_dict())
    with pytest.raises(ValueError, match="CCTPU_UNSAFE_PICKLE=1"):
        clip_convert.load_torch_checkpoint(module)
    with pytest.raises(FileNotFoundError):
        clip_convert.load_torch_checkpoint(str(tmp_path / "missing.pt"))
    monkeypatch.setenv("CCTPU_UNSAFE_PICKLE", "1")
    _assert_trees_equal(clip_convert.load_torch_checkpoint(module), got)


@pytest.mark.parametrize("layout", ["hf", "openai"])
def test_load_clip_reads_a_pt_checkpoint_as_the_jax_app(layout, hf_clip, tmp_path):
    """apps/common.load_clip on a .pt file: HF CLIPModel's layout at the
    shapes of --arch, or OpenAI's (keys under `visual.`) with its config read
    from the file; the tree and config equal the JAX apps' load_clip's."""
    from construction_clip_tpu_torch.apps.common import load_clip

    path = str(tmp_path / "clip.pt")
    sd = hf_clip.state_dict() if layout == "hf" else \
        {k: torch.from_numpy(v) for k, v in _openai_sd(hf_clip).items()}
    torch.save(sd, path)
    got, got_cfg = load_clip(path, arch="tiny")
    want, want_cfg = _jax_common().load_clip(path, arch="tiny")
    _assert_trees_equal(got, want)
    assert _jcfg_dict(got_cfg) == _jcfg_dict(want_cfg)
    if layout == "hf":
        _assert_trees_equal(got, clip_convert.from_hf_state_dict(_sd(hf_clip), CLIP_CFG))


def _no_tensorboard(monkeypatch):
    for mod in ("torch.utils.tensorboard", "tensorboardX"):
        monkeypatch.setitem(sys.modules, mod, None)


def test_train_clipcap_starts_gpt2_from_a_checkpoint(hf_gpt2, tmp_path, monkeypatch):
    """train_clipcap --gpt_checkpoint --only_prefix: the npz's GPT-2 is the
    converted checkpoint, bit for bit (it was frozen)."""
    from construction_clip_tpu_torch.apps import train_clipcap
    from construction_clip_tpu_torch.data.offline_assets import (
        corpus_characters, write_bert_vocab)
    from construction_clip_tpu_torch.train.checkpoint import load_params_npz

    _no_tensorboard(monkeypatch)
    torch.save(hf_gpt2.state_dict(), tmp_path / "gpt2.pt")
    gen = np.random.default_rng(4)
    np.savez(tmp_path / "emb.npz", embeddings=gen.standard_normal((4, 16)).astype(np.float32),
             attributes=np.asarray(["缺失 墜落 "] * 4, dtype=object),
             captions=np.asarray(["工地邊緣", "墜落", "開口", "機械"], dtype=object))
    write_bert_vocab(str(tmp_path / "vocab.txt"), corpus_characters([]), size=128)
    train_clipcap.main([
        "--data", str(tmp_path / "emb.npz"), "--out_dir", str(tmp_path / "m"),
        "--prefix", "cap", "--epochs", "1", "--bs", "2", "--gpt_size", "tiny",
        "--gpt_checkpoint", str(tmp_path / "gpt2.pt"), "--tokenizer", str(tmp_path / "vocab.txt"),
        "--log_dir", str(tmp_path / "log"), "--device", "cpu", "--precision", "fp32",
        "--only_prefix", "--prefix_length", "4", "--attribute_length", "6"])
    ccfg = ClipCapConfig(prefix_length=4, attribute_length=6, clip_dim=16)
    saved = load_params_npz(str(tmp_path / "m" / "cap.npz"),
                            convert.init_clipcap(convert.SHAPES, ccfg, GCFG))
    _assert_trees_equal(saved["gpt"], gpt2.from_hf_state_dict(_sd(hf_gpt2), GCFG))


def test_train_clipcap_t5_starts_t5_from_a_checkpoint(hf_mt5, tmp_path, monkeypatch):
    """train_clipcap_t5 --t5_checkpoint --only_prefix: the npz's T5 is the
    converted checkpoint, bit for bit (it was frozen)."""
    from construction_clip_tpu_torch.apps import train_clipcap_t5, train_tokenizer
    from construction_clip_tpu_torch.train.checkpoint import load_params_npz

    _no_tensorboard(monkeypatch)
    torch.save(hf_mt5.state_dict(), tmp_path / "mt5.pt")
    caps = ["工地 邊緣", "墜落 開口", "機械 物料", "工地 墜落"]
    (tmp_path / "text.txt").write_text("\n".join(caps) + "\n", encoding="utf-8")
    tok = str(tmp_path / "bpe.json")
    train_tokenizer.main(["--input", str(tmp_path / "text.txt"), "--out", tok,
                          "--vocab_size", "60", "--min_frequency", "1"])
    gen = np.random.default_rng(5)
    np.savez(tmp_path / "emb.npz", embeddings=gen.standard_normal((4, 16)).astype(np.float32),
             attributes=np.asarray([""] * 4, dtype=object),
             captions=np.asarray(caps, dtype=object))
    train_clipcap_t5.main([
        "--data", str(tmp_path / "emb.npz"), "--out_dir", str(tmp_path / "m"),
        "--prefix", "t5cap", "--epochs", "1", "--bs", "2", "--t5_size", "tiny",
        "--t5_checkpoint", str(tmp_path / "mt5.pt"), "--tokenizer", tok,
        "--log_dir", str(tmp_path / "log"), "--device", "cpu", "--precision", "fp32",
        "--only_prefix", "--prefix_length", "4", "--max_length", "8"])
    ccfg = ClipCapConfig(prefix_length=4, attribute_length=0, clip_dim=16)
    saved = load_params_npz(str(tmp_path / "m" / "t5cap.npz"),
                            convert.init_clipcap_t5(convert.SHAPES, ccfg, TCFG))
    _assert_trees_equal(saved["t5"], t5.from_hf_state_dict(_sd(hf_mt5), TCFG))


def test_export_embeddings_writes_the_jax_apps_file(hf_gpt2, tmp_path, monkeypatch):
    """export_embeddings --tiny --gpt_checkpoint on a corpus: the same words
    and PCA scores, byte for byte, as the JAX app's file from the same
    checkpoint and vocab.txt."""
    import json

    from construction_clip_tpu_torch.apps import export_embeddings
    from construction_clip_tpu_torch.data.offline_assets import write_bert_vocab

    torch.save(hf_gpt2.state_dict(), tmp_path / "gpt2.pt")
    caps = ["工地邊緣未設置護欄，墜落", "開口未防護一樓", "機械 物料 工地邊緣", "", "ab 12 墜落"]
    anns = [{"id": i, "caption": c, "violation_list": "開口" if not c else "",
             "file_name": f"{i}.jpg"} for i, c in enumerate(caps)]
    (tmp_path / "all.json").write_text(json.dumps({"annotations": anns}, ensure_ascii=False),
                                       encoding="utf-8")
    write_bert_vocab(str(tmp_path / "vocab.txt"), sorted(set("".join(caps))), size=128)
    argv = ["--json_path", str(tmp_path / "all.json"), "--tokenizer",
            str(tmp_path / "vocab.txt"), "--gpt_checkpoint", str(tmp_path / "gpt2.pt"),
            "--tiny", "--top_k", "20"]
    with contextlib.redirect_stdout(io.StringIO()):
        export_embeddings.main(argv + ["--out", str(tmp_path / "port.txt")])
    monkeypatch.syspath_prepend(os.path.join(REPO, "apps"))
    monkeypatch.setattr(sys, "argv", ["export_embeddings"] + argv +
                        ["--out", str(tmp_path / "jax.txt")])
    with contextlib.redirect_stdout(io.StringIO()):
        runpy.run_path(os.path.join(REPO, "apps", "export_embeddings.py"), run_name="__main__")
    got = (tmp_path / "port.txt").read_text(encoding="utf-8")
    assert got == (tmp_path / "jax.txt").read_text(encoding="utf-8")
    lines = got.splitlines()
    assert len(lines) >= 4 and all(len(line.split()) == 1 + GCFG.n_embd for line in lines)
