"""HTTP serving of the port (the counterpart of apps/serve.py, the
`application.py` entry point): POST /predict (multipart image) -> detection,
zero-shot classes and a caption as JSON; GET /ping; GET /.

    python -m construction_clip_tpu_torch.apps.serve --clip_bpe bpe.txt.gz \\
        --tokenizer vocab.txt --enable_detector --batch_window_ms 20

The flags and defaults are apps/serve.py's for what the port serves: the CLIP
checkpoint is the .npz that `train/checkpoint.py` reads or a .pt state
dict (OpenAI's or HF's, apps/common.load_clip), the caption checkpoint such
an .npz (random
weights from numpy seeds 0 and 1 without them, as chip_smoke.py's serving
phases draw them), --clip_bpe and --tokenizer are local
files (a BERT vocab.txt or a `tokenizers` JSON), --int8 quantizes the image
tower and GPT-2 in the port at startup (K7 runs the image tower's attention
halves), and --device is `cuda` (the default; an error where no CUDA device
works) or `cpu`. --enable_detector (or --detector_checkpoint, a
torchvision .pth) adds the Faster R-CNN (serve/detector.TorchDetector on
--device, bf16 on the card, behind the reference's 0.8 threshold; random
weights from numpy seed 0 without a checkpoint), whose batch is coalesced
with the caption batch. Like apps/serve.py the pipeline runs under
DEFAULT_POLICY.
"""

from __future__ import annotations

import argparse

from construction_clip_tpu_torch.apps.common import (
    TokenizerFile, add_device_flag, load_clip, load_clip_tokenizer, resolve_device)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--clip_checkpoint", default=None,
                   help=".npz params (either package's) or a .pt state dict (OpenAI or HF)")
    p.add_argument("--caption_checkpoint", default=None, help=".npz {mapper, gpt}")
    p.add_argument("--clip_bpe", default=None)
    p.add_argument("--tokenizer", default="vocab.txt",
                   help="a BERT vocab.txt or a tokenizers JSON file")
    p.add_argument("--arch", default="vit_b_32",
                   choices=["vit_b_32", "vit_b_16", "vit_l_14", "tiny", "tiny_bpe"])
    p.add_argument("--prefix_length", type=int, default=20)
    p.add_argument("--attribute_length", type=int, default=20)
    p.add_argument("--mapping_type", default="mlp")
    p.add_argument("--greedy", action="store_true", help="greedy decode instead of beam")
    p.add_argument("--int8", action="store_true",
                   help="quantize the CLIP image tower and GPT-2 to int8 at startup")
    p.add_argument("--detector_checkpoint", default=None,
                   help="torchvision fasterrcnn .pth (the reference's model_final.pth)")
    p.add_argument("--enable_detector", action="store_true",
                   help="run the Faster R-CNN (random weights without a checkpoint)")
    p.add_argument("--detector_image_size", type=int, default=800,
                   help="detector staging square (800 = the reference's min-side; "
                        "512 = the fast config)")
    p.add_argument("--detector_geometry", default="letterbox", choices=["letterbox", "crop"],
                   help="letterbox = no content lost (the reference transform's "
                        "contract); crop = centre crop")
    p.add_argument("--detector_num_classes", type=int, default=7,
                   help="head size incl. background (reference application.py:14 builds 7)")
    p.add_argument("--batch_window_ms", type=float, default=0.0,
                   help=">0: coalesce concurrent requests into one device batch")
    p.add_argument("--max_batch", type=int, default=8)
    add_device_flag(p)
    return p.parse_args(argv)


def build_service(args, clip_tok, lm_tok, device):
    """The TorchPredictService that `main` serves, for parsed `args`, on
    `device`, with the given tokenizers."""
    from construction_clip_tpu_torch import convert
    from construction_clip_tpu_torch.core.configs import ClipCapConfig, GPT2Config
    from construction_clip_tpu_torch.core.params import as_tree
    from construction_clip_tpu_torch.infer.caption import CaptionPipeline
    from construction_clip_tpu_torch.serve.app import TorchPredictService
    from construction_clip_tpu_torch.train.checkpoint import load_params_npz

    detector = None
    if args.enable_detector or args.detector_checkpoint:
        from construction_clip_tpu_torch.serve.detector import TorchDetector, ThresholdWrapper

        detector = ThresholdWrapper(TorchDetector(
            args.detector_checkpoint, num_classes=args.detector_num_classes,
            image_size=args.detector_image_size, geometry=args.detector_geometry,
            device=device))
    clip_tree, clip_cfg = load_clip(args.clip_checkpoint, arch=args.arch)
    ccfg = ClipCapConfig(prefix_length=args.prefix_length,
                         attribute_length=args.attribute_length, mapper=args.mapping_type,
                         clip_dim=clip_cfg.text.embed_dim)
    gcfg = GPT2Config() if args.arch != "tiny" else GPT2Config.tiny()
    cap_tree = (load_params_npz(args.caption_checkpoint,
                                convert.init_clipcap(convert.SHAPES, ccfg, gcfg))
                if args.caption_checkpoint else convert.init_clipcap(1, ccfg, gcfg))
    clip_params = as_tree(convert.to_params(clip_tree, device=device))
    cap_params = as_tree(convert.to_params(cap_tree, device=device))
    if args.int8:
        from construction_clip_tpu_torch.models.clip.quant import quantize_clip
        from construction_clip_tpu_torch.models.gpt2 import quantize_gpt2

        clip_params = quantize_clip(clip_params)
        cap_params = dict(cap_params, gpt=quantize_gpt2(cap_params["gpt"]))
    pipe = CaptionPipeline(clip_params=clip_params, clip_cfg=clip_cfg, cap_params=cap_params,
                           ccfg=ccfg, gcfg=gcfg, clip_tokenizer=clip_tok, lm_tokenizer=lm_tok)
    return TorchPredictService(pipe, detector=detector, use_beam=not args.greedy,
                               batch_window_ms=args.batch_window_ms, max_batch=args.max_batch)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    from construction_clip_tpu_torch.core.configs import CLIPConfig
    from construction_clip_tpu_torch.serve.app import serve

    vocab = getattr(CLIPConfig, args.arch)().text.vocab_size
    clip_tok = load_clip_tokenizer(args.clip_bpe,
                                   expect_vocab=vocab if args.clip_checkpoint else None)
    service = build_service(args, clip_tok, TokenizerFile(args.tokenizer), device)
    serve(service, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
