"""The port's copy of construction_clip_tpu/data/corpus.py (host code, no
tensors), held equal to it by tests/test_torch_etl.py and
tests/test_torch_host.py. apps/export_embeddings.py runs its `tokenize_zh`.

Tokenizer-training text corpus — port of reference corpus.py.

Reference pipeline (reference corpus.py:143-175): safety-report PDFs (:50-120,
4 layout formats), regulation PDFs (:122-141), and a zh-wikipedia BFS crawl
(:24-48), all tokenized with spaCy zh and filtered (:16-22), concatenated into
output.txt.

Environment gates are on the I/O edges only — the logic is all here and tested:
  - PDF text extraction needs PyMuPDF (etl.load_report_pages); the caption /
    regulation parsing lives in data/report_parse.py and takes plain strings.
  - The crawler's HTTP fetch needs network egress; the BFS + HTML parsing
    (crawl_wikipedia) takes an injectable fetch(url) -> html callable and is
    tested against local fixtures.
  - spaCy zh is unavailable; tokenize_zh segments CJK runs instead, then applies
    the reference's exact filter rules (drop latin-bearing, digit, space-bearing,
    and excluded-punctuation tokens, corpus.py:16-22).
"""

from __future__ import annotations

import os
import unicodedata
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

# reference corpus.py:17 — tokens CONTAINING any of these are dropped (note 一
# and the ○ box-drawing/table glyphs are in the list: the reports render tables
# into the text layer).
EXCLUDE_PUNCTUATION = (
    "、", "，", "，，", ",", "。", "？", "！", "(", ")", "（", "）", "「", "」",
    "：", "；", "[", "]", "《", "》", "@", ":", ".", "/", "〈", "〉", "_", "#",
    "~", "-", "─", "┌", "│", "┤", "┐", "└", "┘", "┼", "├", "─", "、", "──",
    "├─", "││", "─┼", "┼─", "┤│", "│├", "─┬", "一", "○", "○○", "○○○",
)


def filter_tokens(tokens: Iterable[str]) -> List[str]:
    """The reference's token filter (corpus.py:19-20): drop any token containing
    a latin letter, digit-only tokens, tokens with internal spaces, and tokens
    containing any excluded punctuation string."""
    out = []
    for t in tokens:
        if not t or not t.strip():
            continue
        if any("a" <= c.lower() <= "z" for c in t):
            continue
        if t.isdigit():
            continue
        if " " in t:
            continue
        if any(ex in t for ex in EXCLUDE_PUNCTUATION):
            continue
        out.append(t)
    return out


def tokenize_zh(text: str) -> List[str]:
    """CJK-run segmentation (spaCy zh unavailable): consecutive CJK chars group
    into word candidates; other scripts split on whitespace. Lowercased like the
    reference (corpus.py:18), then reference-filtered."""
    runs: List[str] = []
    cur = ""
    cur_cjk = None
    for ch in text.lower():
        is_cjk = "一" <= ch <= "鿿"
        if ch.isspace():
            if cur:
                runs.append(cur)
            cur, cur_cjk = "", None
        elif cur_cjk is None or is_cjk == cur_cjk:
            cur += ch
            cur_cjk = is_cjk
        else:
            runs.append(cur)
            cur, cur_cjk = ch, is_cjk
    if cur:
        runs.append(cur)
    # punctuation splits CJK runs into sub-words before the filter would drop the
    # whole run for containing it. The excluded CHARACTERS 一/○ (reference
    # corpus.py:17 drops the spaCy WORD containing them) also split here:
    # without word segmentation a run is a whole clause, and dropping the clause
    # for one 一 would lose e.g. all of 工地一樓開口未防護 instead of just 一樓 —
    # splitting keeps the neighbors (a documented approximation: the reference
    # loses 樓 with the word, we keep it).
    split_runs: List[str] = []
    for r in runs:
        word = ""
        for ch in r:
            if (unicodedata.category(ch).startswith("P")
                    or ch in "：。，、；！？（）「」一○"):
                if word:
                    split_runs.append(word)
                word = ""
            else:
                word += ch
        if word:
            split_runs.append(word)
    return filter_tokens(split_runs)


def tokenize(text: str) -> str:
    """Reference signature (corpus.py:16-22): text -> space-joined token string."""
    return " ".join(tokenize_zh(text))


def corpus_from_texts(texts: Iterable[str]) -> List[str]:
    """Text blocks -> filtered token lines (one source line per output line)."""
    lines = []
    for t in texts:
        toks = tokenize_zh(t)
        if toks:
            lines.append(" ".join(toks))
    return lines


def corpus_from_annotations(json_path: str) -> List[str]:
    """Captions + violation lists from an annotation JSON -> corpus lines."""
    from construction_clip_tpu_torch.data.schema import load_annotations

    texts = []
    for a in load_annotations(json_path):
        for t in (a.caption, a.violation_list):
            if t:
                texts.append(t)
    return corpus_from_texts(texts)


def write_corpus(lines: Iterable[str], out_path: str) -> int:
    n = 0
    with open(out_path, "w", encoding="utf-8") as f:
        for line in lines:
            f.write(line + "\n")
            n += 1
    return n


# ---------------------------------------------------------------------------
# Collectors (reference corpus.py main() :143-175)
# ---------------------------------------------------------------------------

def safety_report_lines(report_dir: str) -> List[str]:
    """Safety-report PDFs -> token lines (reference corpus.py:50-120): for every
    embedded image on pages 2+, the page's parsed caption is tokenized. Needs
    PyMuPDF to read the PDFs; the parsing itself is report_parse.py."""
    from construction_clip_tpu_torch.data.etl import load_report_pages
    from construction_clip_tpu_torch.data.report_parse import report_corpus_captions

    lines: List[str] = []
    for file_name in sorted(os.listdir(report_dir)):
        if not file_name.endswith("pdf"):
            continue
        pages = load_report_pages(os.path.join(report_dir, file_name),
                                  with_images=False)
        for caption in report_corpus_captions(pages):
            toks = tokenize(caption)
            if toks:
                lines.append(toks)
    return lines


def regulation_lines(pdf_path: str) -> List[str]:
    """Regulation PDF -> token lines (reference corpus.py:122-141): per page,
    newline-stripped text split on 、 with each segment's last char dropped,
    re-concatenated and tokenized."""
    from construction_clip_tpu_torch.data.etl import load_report_pages
    from construction_clip_tpu_torch.data.report_parse import regulation_text_lines

    pages = load_report_pages(pdf_path, with_images=False)
    lines = []
    for text in regulation_text_lines(p.text for p in pages):
        toks = tokenize(text)
        if toks:
            lines.append(toks)
    return lines


WIKI_PREFIX = "https://zh.wikipedia.org/zh-tw"
WIKI_EXCLUDE = ("Category", "Special", "Portal", "Help", "index.php", "wikidata")


def _default_fetch(url: str) -> str:
    """Live HTTP fetch — only reachable with network egress."""
    import requests

    return requests.get(url=url, timeout=30).content.decode("utf-8", "replace")


def crawl_page(html: str) -> Tuple[str, List[str], List[str]]:
    """Parse one wiki page (reference corpus.py:28-47): (first <h1> title,
    tokenized <p> text lines, outgoing wiki links from <a href> without class)."""
    from bs4 import BeautifulSoup

    soup = BeautifulSoup(html, "html.parser")
    h1 = soup.find_all("h1")
    title = h1[0].text if h1 else ""
    lines: List[str] = []
    urls: List[str] = []
    for paragraph in soup.find_all(["p"]):
        toks = tokenize(paragraph.text.replace("\n", ""))
        if toks:
            lines.append(toks)
        for element in paragraph.find_all(["a"], href=True, class_=False):
            url = WIKI_PREFIX + element["href"].replace("/wiki", "")
            if all(s not in url for s in WIKI_EXCLUDE) and "cite_note" not in url:
                urls.append(url)
    return title, lines, urls


def crawl_wikipedia(seed_urls: Sequence[str], *, num_layers: int = 2,
                    fetch: Optional[Callable[[str], str]] = None,
                    max_pages: Optional[int] = None,
                    ) -> Tuple[List[str], List[str]]:
    """BFS crawl, num_layers deep (reference corpus.py:24-48,162-165). Returns
    (token lines, page titles). `fetch` injects the HTTP layer — pass a local-
    fixture reader for offline use; the default does live HTTP (needs egress)."""
    if fetch is None:
        fetch = _default_fetch
    lines: List[str] = []
    titles: List[str] = []
    url_list = list(seed_urls)
    fetched = 0
    for _ in range(num_layers):
        new_urls: List[str] = []
        for url in url_list:
            if max_pages is not None and fetched >= max_pages:
                break
            try:
                html = fetch(url)
            except Exception as e:  # reference skips failures silently via tqdm
                print(f"skip {url}: {e}")
                continue
            fetched += 1
            title, page_lines, page_urls = crawl_page(html)
            titles.append(title)
            lines.extend(page_lines)
            new_urls.extend(page_urls)
        url_list = new_urls
    return lines, titles


def build_corpus(*, report_dir: Optional[str] = None,
                 regulation_pdf: Optional[str] = None,
                 wiki_seeds: Sequence[str] = (),
                 annotation_jsons: Sequence[str] = (),
                 num_layers: int = 2,
                 fetch: Optional[Callable[[str], str]] = None,
                 out_path: Optional[str] = None) -> List[str]:
    """The reference main() (corpus.py:143-175): safety reports + regulation +
    wiki crawl, concatenated; sources are optional so offline runs can build
    from whatever is present (annotation JSONs stand in for the crawl)."""
    lines: List[str] = []
    if report_dir:
        lines += safety_report_lines(report_dir)
    if regulation_pdf:
        lines += regulation_lines(regulation_pdf)
    for j in annotation_jsons:
        lines += corpus_from_annotations(j)
    if wiki_seeds:
        wiki_lines, _titles = crawl_wikipedia(wiki_seeds, num_layers=num_layers,
                                              fetch=fetch)
        lines += wiki_lines
    if out_path:
        write_corpus(lines, out_path)
    return lines
