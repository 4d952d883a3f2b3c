"""Dataset ETL (the port's counterpart of apps/etl.py, with its subcommands
and flags; host code that touches no tensor, so it takes no --device): the
`image.py` + `corpus.py` entry points as subcommands:

  folder-month / folder-other / folder-labeled   folders -> annotation JSON
  docx                                           DOCX reports (needs docx2txt)
  pdf-report                                     PDF safety reports (needs PyMuPDF)
  correct-names | count | add-key | add-path | combine
  corpus                                         annotation JSON -> tokenizer text
  build-corpus                                   reports+regulation+wiki -> output.txt
                                                 (reference corpus.py main)
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    fm = sub.add_parser("folder-month")
    fm.add_argument("root")
    fm.add_argument("--out", required=True)
    fm.add_argument("--years", type=int, nargs="+", default=[2021, 2022])

    fo = sub.add_parser("folder-other")
    fo.add_argument("root")
    fo.add_argument("--out", required=True)
    fo.add_argument("--folders", nargs="+", default=["其他"])

    fl = sub.add_parser("folder-labeled")
    fl.add_argument("root")
    fl.add_argument("--out", required=True)

    dx = sub.add_parser("docx")
    dx.add_argument("root")
    dx.add_argument("--out", required=True)

    cn = sub.add_parser("correct-names")
    cn.add_argument("json_path")

    ct = sub.add_parser("count")
    ct.add_argument("json_path")

    ak = sub.add_parser("add-key")
    ak.add_argument("json_path")
    ak.add_argument("--key", default="objects")
    ak.add_argument("--value", default="")

    ap = sub.add_parser("add-path")
    ap.add_argument("json_path")
    ap.add_argument("--prefix", required=True)

    cb = sub.add_parser("combine")
    cb.add_argument("inputs", nargs="+")
    cb.add_argument("--out", required=True)

    cp = sub.add_parser("corpus")
    cp.add_argument("json_path")
    cp.add_argument("--out", default="output.txt")

    pr = sub.add_parser("pdf-report")
    pr.add_argument("report_dir")
    pr.add_argument("--out", required=True)
    pr.add_argument("--image-out", default=None,
                    help="directory for extracted report photos")

    bc = sub.add_parser("build-corpus")
    bc.add_argument("--report-dir", default=None)
    bc.add_argument("--regulation-pdf", default=None)
    bc.add_argument("--annotations", nargs="*", default=[])
    bc.add_argument("--wiki-seeds", nargs="*", default=[],
                    help="zh-wikipedia seed URLs (needs network egress)")
    bc.add_argument("--num-layers", type=int, default=2)
    bc.add_argument("--out", default="output.txt")

    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from construction_clip_tpu_torch.data import etl
    from construction_clip_tpu_torch.data.corpus import corpus_from_annotations, write_corpus

    if args.cmd == "folder-month":
        n = len(etl.convert_folder_month(args.root, years=args.years, out_path=args.out))
    elif args.cmd == "folder-other":
        n = len(etl.convert_folder_other(args.root, folders=args.folders, out_path=args.out))
    elif args.cmd == "folder-labeled":
        n = len(etl.convert_folder_labeled(args.root, out_path=args.out))
    elif args.cmd == "docx":
        n = len(etl.convert_docx(args.root, out_path=args.out))
    elif args.cmd == "correct-names":
        etl.image_name_correction(args.json_path)
        n = "ok"
    elif args.cmd == "count":
        print(json.dumps(etl.count(args.json_path), ensure_ascii=False, indent=2))
        return
    elif args.cmd == "add-key":
        etl.add_key(args.json_path, args.key, args.value)
        n = "ok"
    elif args.cmd == "add-path":
        etl.add_path(args.json_path, args.prefix)
        n = "ok"
    elif args.cmd == "combine":
        n = etl.combine(args.inputs, args.out)
    elif args.cmd == "corpus":
        n = write_corpus(corpus_from_annotations(args.json_path), args.out)
    elif args.cmd == "pdf-report":
        n = len(etl.convert_pdf_report(args.report_dir, output_dir=args.image_out,
                                       out_path=args.out))
    elif args.cmd == "build-corpus":
        from construction_clip_tpu_torch.data.corpus import build_corpus

        n = len(build_corpus(report_dir=args.report_dir,
                             regulation_pdf=args.regulation_pdf,
                             annotation_jsons=args.annotations,
                             wiki_seeds=args.wiki_seeds,
                             num_layers=args.num_layers, out_path=args.out))
    print(n)


if __name__ == "__main__":
    main()
