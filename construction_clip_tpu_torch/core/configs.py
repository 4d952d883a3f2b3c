"""Model configs of the ported slices.

Copied from construction_clip_tpu/core/configs.py (pure dataclasses, same names,
fields and defaults): that module is importable only through
construction_clip_tpu/core/__init__.py, which imports jax. The port's tests hold
these copies equal to the originals. Port functions read only attributes, so a
config object of either package works with them.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    embed_dim: int = 512  # output projection dim (shared image/text space)

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1  # + class token


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    layers: int = 12
    heads: int = 8
    embed_dim: int = 512


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """OpenAI-CLIP-compatible two-tower config (defaults = ViT-B/32), QuickGELU."""

    vision: VisionConfig = VisionConfig()
    text: TextConfig = TextConfig()
    quick_gelu: bool = True
    logit_scale_init: float = 2.6592  # ln(1/0.07), OpenAI init

    @staticmethod
    def vit_b_32() -> "CLIPConfig":
        return CLIPConfig()

    @staticmethod
    def vit_b_16() -> "CLIPConfig":
        return CLIPConfig(vision=VisionConfig(patch_size=16))

    @staticmethod
    def vit_l_14() -> "CLIPConfig":
        return CLIPConfig(
            vision=VisionConfig(patch_size=14, width=1024, layers=24, heads=16, embed_dim=768),
            text=TextConfig(width=768, heads=12, embed_dim=768),
        )

    @staticmethod
    def tiny() -> "CLIPConfig":
        """Small config for tests."""
        return CLIPConfig(
            vision=VisionConfig(image_size=32, patch_size=8, width=64, layers=2, heads=2,
                                embed_dim=32),
            text=TextConfig(vocab_size=256, context_length=16, width=32, layers=2, heads=2,
                            embed_dim=32),
        )

    @staticmethod
    def tiny_bpe() -> "CLIPConfig":
        """tiny, with the 520-token vocabulary of a 6-merge ClipTokenizer
        (tools/make_offline_assets.py --tiny), for end-to-end CLI runs."""
        return CLIPConfig(
            vision=VisionConfig(image_size=32, patch_size=8, width=64, layers=2, heads=2,
                                embed_dim=32),
            text=TextConfig(vocab_size=520, context_length=24, width=32, layers=2, heads=2,
                            embed_dim=32),
        )


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """HF-GPT2-compatible decoder config (defaults = ckiplab/gpt2-base-chinese size:
    vocab 21128, 12 layers, width 768)."""

    vocab_size: int = 21128
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5

    @staticmethod
    def tiny() -> "GPT2Config":
        return GPT2Config(vocab_size=128, n_positions=64, n_embd=32, n_layer=2, n_head=2)


@dataclasses.dataclass(frozen=True)
class T5Config:
    """HF-mT5-compatible encoder-decoder config (defaults = google/mt5-small)."""

    vocab_size: int = 250112
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 1024
    num_layers: int = 8
    num_decoder_layers: int = 8
    num_heads: int = 6
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    tie_word_embeddings: bool = False

    @staticmethod
    def tiny() -> "T5Config":
        return T5Config(vocab_size=100, d_model=32, d_kv=8, d_ff=64,
                        num_layers=2, num_decoder_layers=2, num_heads=2)


@dataclasses.dataclass(frozen=True)
class ClipCapConfig:
    """Prefix-captioning stack config (reference defaults: prefix 20, attribute
    20, CLIP dim 512, MLP mapper)."""

    prefix_length: int = 20
    attribute_length: int = 20
    clip_dim: int = 512
    mapper: str = "mlp"  # "mlp" | "transformer"
    mapper_layers: int = 8
    clip_length: int = 10  # prefix tokens fed to TransformerMapper
    only_prefix: bool = True  # ClipCaptionPrefix: freeze the LM, train mapper only
