"""PyTorch port, the host data tools: every subcommand of the port's
apps/etl.py against the JAX package's apps/etl.py run in-process (runpy,
sys.argv patched), byte-equal output files and stdout; the crawler's fetch
hook; and the four captioners' datasets of data/datasets.py against the JAX
package's. PyMuPDF (`fitz`), `docx2txt` and `requests` are stand-in modules
here: nothing reads a real PDF or DOCX, and nothing touches the network."""

import io
import json
import os
import runpy
import shutil
import sys
import types
from contextlib import redirect_stdout

import numpy as np
import pytest

from construction_clip_tpu.data import corpus as j_corpus
from construction_clip_tpu.data import datasets as j_datasets
from construction_clip_tpu_torch.apps import etl as etl_app
from construction_clip_tpu_torch.data import corpus, datasets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# page texts of tests/test_report_parse.py (layouts A and D) and a regulation page
TEXT_A = ("公司內部文件，限內部審閱\n查核照片\n查核項目：\n查核項目：\n"
          "查核項目： 屋頂尚未整理\n半邊鷹架扶手先行\n")
TEXT_A_VIOLATION = ("公司內部文件，限內部審閱\n查核照片\n"
                    "查核項目： 缺失改善，開口未設護欄\n")
TEXT_D = "工地現況\nA0南棟一樓整理，作為勞工休息區。\n泥作材料進場。\n"
REGULATION = "第一條、雇主對於工作場所甲\n第二條、防護具乙\n"
PDFS = {
    "20200921-邱董至大埔美榮勝廠房-品質及勞安查核報告.pdf": [
        ("封面 公司內部文件\n", 1), (TEXT_A, 3), (TEXT_A_VIOLATION, 2)],
    "20210305-王至北區倉庫-查核報告.pdf": [("封面\n", 1), (TEXT_D, 3), ("工地名稱 今日\n", 2)],
    "regulation.pdf": [(REGULATION, 0), (REGULATION.replace("甲", "丙"), 0)],
}
# tests/test_report_parse.py's wiki pages
WIKI = {
    "seed": """<html><body><h1>土木工程</h1>
<p>土木工程是一門工程學科。
<a href="/wiki/工程">工程</a>
<a href="/wiki/Category:學科">cat</a>
<a class="ext" href="/wiki/外部">ext</a>
</p>
<p>涵蓋結構與 <a href="/wiki/水利工程#cite_note-1">引文</a> 設計。</p>
</body></html>""",
    "other": "<html><body><h1>工程</h1><p>工程是改造自然的活動。</p></body></html>",
}


def _wiki_page(url):
    if "missing" in url:
        raise OSError("no such page")
    return WIKI["seed"] if "seed" in url else WIKI["other"]


def _fitz():
    """A stand-in PyMuPDF: open(path) gives the pages of PDFS[basename]."""
    class Page:
        def __init__(self, text, n, base):
            self.text, self.xrefs = text, [(base + i,) for i in range(n)]

        def get_images(self):
            return self.xrefs

        def get_text(self, kind):
            assert kind == "text"
            return self.text

    class Doc(list):
        def extract_image(self, xref):
            return {"ext": "jpeg", "image": b"\xff\xd8" + bytes([xref % 256]) * 5}

    def open_(path):
        return Doc(Page(text, n, 10 * i) for i, (text, n) in
                   enumerate(PDFS[os.path.basename(path)]))

    return types.SimpleNamespace(open=open_)


def _docx2txt():
    def process(path, img_dir):
        name = os.path.basename(path)
        return ("安衛缺失照片\n" + name + "\n表頭\n缺失說明\n照片\n勞工未戴安全帽\n\n\n"
                "現場狀況良好\n開口未設護欄\n")

    return types.SimpleNamespace(process=process)


def _requests():
    def get(url, timeout):
        return types.SimpleNamespace(content=_wiki_page(url).encode("utf-8"))

    return types.SimpleNamespace(get=get)


@pytest.fixture
def stubs(monkeypatch):
    for name, make in (("fitz", _fitz), ("docx2txt", _docx2txt), ("requests", _requests)):
        monkeypatch.setitem(sys.modules, name, make())


def _tree(root):
    """tests/test_etl.py's reju- and fengyu-style trees, the report PDFs and
    DOCX files, and an annotation corpus."""
    for status in ("合格", "不合格"):
        for cat in ("開口", "安全帽", "施工架"):
            d = root / "reju" / status / cat
            d.mkdir(parents=True)
            for i in range(2):
                (d / f"img_{i}.jpg").write_bytes(b"x")
    for month in ("2021年03月照片", "2022年11月照片"):
        m = root / "fengyu" / month
        m.mkdir(parents=True)
        (m / "工人未戴安全帽.jpg").write_bytes(b"x")
        (m / "開口未防護.png").write_bytes(b"x")
        (m / "notes").write_bytes(b"x")
        (m / "notes.txt").write_bytes(b"x")   # listed: _list_images passes dotted names
    for folder in ("其他", "雜項"):
        (root / "fengyu" / folder).mkdir()
        (root / "fengyu" / folder / "misc.jpg").write_bytes(b"x")
    (root / "reports").mkdir()
    for name in PDFS:
        if name != "regulation.pdf":
            (root / "reports" / name).write_bytes(b"%PDF")
    (root / "reports" / "skip.txt").write_bytes(b"x")
    (root / "regulation.pdf").write_bytes(b"%PDF")
    (root / "docx").mkdir()
    for name in ("安衛缺失照片202206.docx", "安衛缺失照片202106.docx", "~$安衛缺失照片.docx"):
        (root / "docx" / name).write_bytes(b"PK")
    anns = [{"id": i, "caption_type": ["violation", "status"][i % 2],
             "violation_type": ["墜落", ""][i % 2], "violation_list": f"開口未防護{i}",
             "caption": ["工人未戴安全帽 at site 3！", "", "（鋼筋）外露，施工架"][i % 3],
             "file_name": f"2022{6 + i % 2:02}_{i + 1}.jpg", "objects": "",
             "report_file_name": ["安衛缺失照片202206.docx", ""][i % 2]}
            for i in range(6)]
    for name, rows in (("a.json", anns[:4]), ("b.json", anns[3:])):
        (root / name).write_text(json.dumps({"type": "captions", "annotations": rows},
                                            ensure_ascii=False), encoding="utf-8")


SUBCOMMANDS = {
    "folder-month": ["{t}/fengyu", "--out", "{o}/out.json", "--years", "2021", "2022"],
    "folder-other": ["{t}/fengyu", "--out", "{o}/out.json", "--folders", "其他", "雜項"],
    "folder-labeled": ["{t}/reju", "--out", "{o}/out.json"],
    "docx": ["{o}/docx", "--out", "{o}/out.json"],
    "pdf-report": ["{t}/reports", "--out", "{o}/out.json", "--image-out", "{o}/photos"],
    "correct-names": ["{o}/a.json"],
    "count": ["{t}/a.json"],
    "add-key": ["{o}/a.json", "--key", "objects", "--value", "護欄"],
    "add-path": ["{o}/a.json", "--prefix", "fengyu/"],
    "combine": ["{t}/a.json", "{t}/b.json", "--out", "{o}/out.json"],
    "corpus": ["{t}/a.json", "--out", "{o}/out.txt"],
    "build-corpus": ["--report-dir", "{t}/reports", "--regulation-pdf", "{t}/regulation.pdf",
                     "--annotations", "{t}/a.json", "{t}/b.json",
                     "--wiki-seeds", "http://local/seed", "http://local/missing",
                     "--num-layers", "2", "--out", "{o}/out.txt"],
}


def _files(root):
    """{path: bytes} under root, root's own path in the bytes (pdf-report
    names its --image-out in file_name) made "<out>"."""
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), "rb").read().replace(str(root).encode(), b"<out>")
            for d, _, fs in os.walk(root) for f in fs}


@pytest.mark.parametrize("cmd", list(SUBCOMMANDS))
def test_each_subcommand_writes_the_jax_apps_bytes(cmd, tmp_path, stubs, monkeypatch):
    """The same arguments through both apps, each into a directory of its own
    (seeded with a.json and the DOCX folder, which some subcommands rewrite or
    write into): equal stdout and byte-equal files, each directory's own
    path made "<out>"."""
    tree = tmp_path / "tree"
    tree.mkdir()
    _tree(tree)
    outs = {}
    for who in ("jax", "port"):
        o = tmp_path / who
        o.mkdir()
        shutil.copy(tree / "a.json", o / "a.json")
        shutil.copytree(tree / "docx", o / "docx")
        argv = [cmd] + [a.format(t=tree, o=o) for a in SUBCOMMANDS[cmd]]
        buf = io.StringIO()
        with redirect_stdout(buf):
            if who == "jax":
                monkeypatch.setattr(sys, "argv", ["etl.py"] + argv)
                runpy.run_path(os.path.join(REPO, "apps", "etl.py"), run_name="__main__")
            else:
                etl_app.main(argv)
        outs[who] = (buf.getvalue().replace(str(o), "<out>"), _files(o))
    assert outs["port"][0] == outs["jax"][0]
    assert outs["port"][1] == outs["jax"][1]
    assert outs["port"][0].strip() not in ("", "0")


def test_the_flags_are_the_jax_apps(monkeypatch):
    """Every subcommand's arguments: names, defaults, nargs, types and
    requirement (each app's parser caught at its parse_args)."""
    import argparse

    parsers = []

    def keep(self, args=None, namespace=None):
        parsers.append(self)
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", keep)
    for run in (lambda: runpy.run_path(os.path.join(REPO, "apps", "etl.py"),
                                       run_name="__main__"),
                lambda: etl_app.parse_args(["count", "x"])):
        with pytest.raises(SystemExit):
            run()

    def table(parser):
        sub = next(a for a in parser._actions if a.dest == "cmd")
        return {name: [(a.dest, a.default, a.nargs, a.required, a.type, a.option_strings)
                       for a in p._actions] for name, p in sub.choices.items()}

    orig, port = parsers
    assert table(port) == table(orig)
    assert set(table(port)) == set(SUBCOMMANDS)


def test_crawl_wikipedia_through_its_fetch_hook_gives_the_jax_lines():
    for kw in (dict(num_layers=2), dict(num_layers=1), dict(num_layers=3, max_pages=2)):
        seeds = ["http://local/seed", "http://local/missing"]
        got = corpus.crawl_wikipedia(seeds, fetch=_wiki_page, **kw)
        assert got == j_corpus.crawl_wikipedia(seeds, fetch=_wiki_page, **kw)
    assert corpus.crawl_page(WIKI["seed"]) == j_corpus.crawl_page(WIKI["seed"])
    text = "工人未戴安全帽 at site 3！開口未設護欄。"
    assert corpus.tokenize(text) == j_corpus.tokenize(text)
    assert corpus.corpus_from_texts([text, "", "only english"]) == \
        j_corpus.corpus_from_texts([text, "", "only english"])


def _fake_encode(text):
    return [ord(c) % 500 + 10 for c in text]


def test_flickr_and_coco_datasets_give_the_jax_items(tmp_path):
    csv = tmp_path / "captions.txt"
    csv.write_text("image,caption\na.jpg,a man on a scaffold\nb.jpg,an open pit\nc.jpg\n"
                   "d.jpg,\"quoted, with comma\"\n", encoding="utf-8")
    coco = tmp_path / "coco.json"
    coco.write_text(json.dumps({
        "images": [{"id": 1, "file_name": "x.jpg"}, {"id": 2, "file_name": "y.jpg"}],
        "annotations": [{"image_id": 1, "caption": "cap one"},
                        {"image_id": 2, "caption": "cap two"},
                        {"image_id": 9, "caption": "orphan"}, {"caption": "no id"}],
    }), encoding="utf-8")
    for cls, path in (("FlickrDataset", csv), ("CocoCaptionDataset", coco)):
        for image_dir in ("", "imgs"):
            port = getattr(datasets, cls)(str(path), image_dir=image_dir)
            orig = getattr(j_datasets, cls)(str(path), image_dir=image_dir)
            assert len(port) == len(orig) > 0
            assert [port[i] for i in range(len(port))] == [orig[i] for i in range(len(orig))]


def test_precomputed_and_original_clipcap_datasets_give_the_jax_items(tmp_path):
    gen = np.random.default_rng(31)
    arrays = (gen.standard_normal((5, 4)), gen.integers(0, 9, (5, 3)),
              gen.integers(0, 9, (5, 2)))
    port, orig = (datasets.PrecomputedCaptionDataset(*arrays),
                  j_datasets.PrecomputedCaptionDataset(*arrays))
    assert len(port) == len(orig) == 5
    for i in range(5):
        for g, w in zip(port[i], orig[i]):
            np.testing.assert_array_equal(g, w)

    caps = ["墜落危險", "工人未戴安全帽於高處作業", "電線裸露", "開口"]
    embeds = gen.standard_normal((4, 6)).astype(np.float32)
    for kw in (dict(prefix_length=3), dict(prefix_length=2, normalize_prefix=True)):
        for cache in (None, "cache.pkl"):
            made = []
            for mod in (datasets, j_datasets):
                path = None if cache is None else str(tmp_path / f"{mod.__name__}_{cache}")
                made.append(mod.OriginalClipCapDataset(embeds, caps, _fake_encode,
                                                       cache_path=path, **kw))
                if path is not None:   # built once, then read back from its cache
                    made[-1] = mod.OriginalClipCapDataset(embeds, caps, None,
                                                          cache_path=path, **kw)
            port, orig = made
            assert port.max_seq_len == orig.max_seq_len and len(port) == len(orig) == 4
            # twice over: the second pad_tokens call sees the clamped row
            for _ in range(2):
                for i in range(4):
                    for g, w in zip(port[i], orig[i]):
                        np.testing.assert_array_equal(g, w)
