"""Structured-PDF parsing pipeline for the OpenParse-compatible parser
(reference: python/pathway/xpacks/llm/openparse_utils.py:1-409 —
PyMuDocumentParser + ingestion pipelines over the openparse node model).

This build re-derives the pipeline dependency-free: document elements
come from the built-in positioned-run PDF extractor
(xpacks/llm/parsers.py), tables from the run-clustering table detector,
and vision parsing from any BaseChat-compatible (mockable) LLM. Nodes
are plain dicts ``{"text", "page", "kind"}`` flowing through an
``IngestionPipeline.process`` step, mirroring the reference's
processing-pipeline customization point.
"""

from __future__ import annotations

import re
from abc import ABC, abstractmethod

Node = dict  # {"text": str, "page": int, "kind": "text"|"table"|"image"}


class IngestionPipeline(ABC):
    """Post-processing over parsed nodes (reference: openparse's
    processing pipelines; openparse_utils.py custom pipelines)."""

    @abstractmethod
    def process(self, nodes: list[Node]) -> list[Node]:
        ...


class SimpleIngestionPipeline(IngestionPipeline):
    """The default cleanup (reference: SimpleIngestionPipeline —
    'combines close elements, combines headers with the text body, and
    removes weirdly formatted/small elements'):

    * short heading-like text nodes merge into the next text node of the
      same page;
    * consecutive text nodes on one page merge into paragraphs;
    * leftover nodes shorter than ``min_chars`` (and not tables/images)
      are dropped.
    """

    def __init__(self, min_chars: int = 15):
        self.min_chars = min_chars

    @staticmethod
    def _heading_like(text: str) -> bool:
        t = text.strip()
        return 0 < len(t) <= 60 and not t.endswith((".", ",", ";", ":"))

    def process(self, nodes: list[Node]) -> list[Node]:
        out: list[Node] = []
        pending: Node | None = None
        for node in nodes:
            if node["kind"] != "text":
                if pending is not None:
                    out.append(pending)
                    pending = None
                out.append(node)
                continue
            if pending is not None and pending["page"] == node["page"]:
                joiner = (
                    "\n" if self._heading_like(pending["text"]) else " "
                )
                pending = {
                    **pending,
                    "text": pending["text"].rstrip()
                    + joiner
                    + node["text"].lstrip(),
                }
            else:
                if pending is not None:
                    out.append(pending)
                pending = dict(node)
        if pending is not None:
            out.append(pending)
        return [
            n
            for n in out
            if n["kind"] != "text"
            or len(n["text"].strip()) >= self.min_chars
        ]


class SamePageIngestionPipeline(IngestionPipeline):
    """One chunk per page (reference: SamePageIngestionPipeline): all of
    a page's text and table markdown joins into a single node."""

    def process(self, nodes: list[Node]) -> list[Node]:
        by_page: dict[int, list[Node]] = {}
        order: list[int] = []
        for node in nodes:
            page = node["page"]
            if page not in by_page:
                by_page[page] = []
                order.append(page)
            by_page[page].append(node)
        out = []
        for page in order:
            text = "\n\n".join(
                n["text"].strip() for n in by_page[page] if n["text"].strip()
            )
            if text:
                out.append({"text": text, "page": page, "kind": "text"})
        return out


_TABLE_ALGORITHMS = ("llm", "pymupdf", "unitable", "table-transformers")


class PyMuDocumentParser:
    """Document → nodes driver (reference: openparse_utils.py
    PyMuDocumentParser — named for surface parity; the extraction here is
    the built-in dependency-free positioned-run engine, with the
    table/image parsing strategy injected through table_args/image_args).

    table_args["parsing_algorithm"]:
      * "llm" — each detected table's grid is rendered to markdown and
        passed to table_args["llm"] with table_args["prompt"] for
        explanation/normalization (vision-LLM table parsing);
      * "pymupdf" / "unitable" / "table-transformers" — the local
        positional extractor emits the markdown directly (these names
        select upstream models the reference downloads at runtime; the
        local detector is this build's deterministic stand-in, same
        markdown-table output contract).
    """

    def __init__(
        self,
        table_args: dict | None = None,
        image_args: dict | None = None,
        processing_pipeline: IngestionPipeline | None = None,
    ):
        if table_args is not None:
            alg = table_args.get("parsing_algorithm")
            if alg not in _TABLE_ALGORITHMS:
                raise ValueError(
                    f"table_args.parsing_algorithm must be one of "
                    f"{_TABLE_ALGORITHMS}, got {alg!r}"
                )
            if alg == "llm" and "llm" not in table_args:
                raise ValueError(
                    "table_args with parsing_algorithm='llm' needs an "
                    "'llm' entry (a chat model)"
                )
        if image_args is not None and "llm" not in image_args:
            raise ValueError("image_args needs an 'llm' entry")
        self.table_args = table_args
        self.image_args = image_args
        self.processing_pipeline = (
            processing_pipeline
            if processing_pipeline is not None
            else SimpleIngestionPipeline()
        )

    async def _llm_text(self, llm, prompt: str, body) -> str:
        import inspect

        if isinstance(body, str):
            content = [{"type": "text", "text": f"{prompt}\n\n{body}"}]
        else:  # image bytes -> data url
            import base64

            b64 = base64.b64encode(body).decode()
            content = [
                {"type": "text", "text": prompt},
                {
                    "type": "image_url",
                    "image_url": {"url": f"data:image/png;base64,{b64}"},
                },
            ]
        res = llm.func([{"role": "user", "content": content}])
        if inspect.iscoroutine(res):
            res = await res
        return res

    async def parse(self, contents: bytes) -> list[Node]:
        from pathway_tpu_torch.xpacks.llm.parsers import (
            _builtin_pdf_pages,
            _table_to_markdown,
            pdf_tables,
        )

        nodes: list[Node] = []
        for page, text in enumerate(_builtin_pdf_pages(contents)):
            for para in re.split(r"\n\s*\n", text):
                para = " ".join(para.split())
                if para:
                    nodes.append(
                        {"text": para, "page": page, "kind": "text"}
                    )
        if self.table_args is not None:
            alg = self.table_args["parsing_algorithm"]
            for page, table in pdf_tables_by_page(contents):
                md = _table_to_markdown(table)
                if alg == "llm":
                    md = await self._llm_text(
                        self.table_args["llm"],
                        self.table_args.get(
                            "prompt",
                            "Explain the given table in markdown format.",
                        ),
                        md,
                    )
                nodes.append({"text": md, "page": page, "kind": "table"})
        if self.image_args is not None:
            # image XObjects carry no page linkage without walking the
            # object-reference graph; captions attach to page 0
            for image in extract_pdf_images(contents):
                caption = await self._llm_text(
                    self.image_args["llm"],
                    self.image_args.get(
                        "prompt", "Explain the given image in detail."
                    ),
                    image,
                )
                nodes.append({"text": caption, "page": 0, "kind": "image"})
        return self.processing_pipeline.process(nodes)


def pdf_tables_by_page(data: bytes) -> list[tuple[int, list[list[str]]]]:
    """(page_index, table_grid) for every detected table — the per-page
    sibling of parsers.pdf_tables, so table nodes carry real page
    metadata (merge_same_page and the slides metadata surface depend on
    it)."""
    from pathway_tpu_torch.xpacks.llm.parsers import (
        _pdf_content_runs,
        _pdf_text_streams,
        _runs_to_tables,
    )

    out = []
    for page, candidates in enumerate(_pdf_text_streams(data)):
        for content in candidates:
            runs = _pdf_content_runs(content)
            if runs:
                for table in _runs_to_tables(runs):
                    out.append((page, table))
                break
    return out


_IMAGE_OBJ_RE = re.compile(
    rb"/Subtype\s*/Image.*?stream\r?\n(.*?)endstream", re.DOTALL
)


def extract_pdf_images(data: bytes) -> list[bytes]:
    """Raw bytes of every image XObject stream in the document (the
    vision pipeline's input; encodings pass through untouched — vision
    models accept JPEG/PNG payloads directly)."""
    return [m.group(1).rstrip(b"\r\n") for m in _IMAGE_OBJ_RE.finditer(data)]
