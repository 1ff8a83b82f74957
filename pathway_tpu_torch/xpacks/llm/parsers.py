"""Document parsers (reference: python/pathway/xpacks/llm/parsers.py:53-928).

Parsers are UDFs: bytes -> list[(text, metadata_dict)]. ParseUtf8 is pure;
the heavier ones (unstructured, pypdf, vision pipelines) gate on their
libraries and degrade with a clear ImportError."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.udfs import UDF


def _as_text(contents) -> str:
    if isinstance(contents, bytes):
        return contents.decode("utf-8", errors="replace")
    return str(contents)


class ParseUtf8(UDF):
    """reference: parsers.py:53 (a.k.a. Utf8Parser)."""

    def __init__(self, **kwargs):
        async def parse(contents) -> list:
            return [(_as_text(contents), {})]

        super().__init__(parse, return_type=list, deterministic=True)


Utf8Parser = ParseUtf8


class ParseUnstructured(UDF):
    """reference: parsers.py ParseUnstructured — unstructured-io backed."""

    def __init__(self, mode: str = "single", post_processors=None, **kwargs):
        try:
            from unstructured.partition.auto import partition  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "ParseUnstructured requires the `unstructured` package"
            ) from e
        self.mode = mode
        self.extra = kwargs

        async def parse(contents, **kw) -> list:
            import io

            from unstructured.partition.auto import partition

            elements = partition(
                file=io.BytesIO(
                    contents if isinstance(contents, bytes) else str(contents).encode()
                ),
                **self.extra,
            )
            if self.mode == "single":
                return [("\n\n".join(str(e) for e in elements), {})]
            return [
                (str(e), dict(getattr(e, "metadata", None) and e.metadata.to_dict() or {}))
                for e in elements
            ]

        super().__init__(parse, return_type=list, deterministic=True)


UnstructuredParser = ParseUnstructured


def _pdf_unescape(raw: bytes) -> str:
    """PDF literal-string unescaping ((), \\, octal, \\n...)."""
    out = []
    i = 0
    esc = {
        ord("n"): "\n", ord("r"): "\r", ord("t"): "\t",
        ord("b"): "\b", ord("f"): "\f",
        ord("("): "(", ord(")"): ")", ord("\\"): "\\",
    }
    while i < len(raw):
        c = raw[i]
        if c == 0x5C and i + 1 < len(raw):  # backslash
            n = raw[i + 1]
            if n in esc:
                out.append(esc[n])
                i += 2
                continue
            if 0x30 <= n <= 0x37:  # octal
                j = i + 1
                digits = b""
                while j < len(raw) and len(digits) < 3 and 0x30 <= raw[j] <= 0x37:
                    digits += bytes([raw[j]])
                    j += 1
                out.append(chr(int(digits, 8)))
                i = j
                continue
            i += 1
            continue
        out.append(chr(c))
        i += 1
    return "".join(out)


def _pdf_content_text(content: bytes) -> str:
    """Text shown by a content stream: literal strings inside BT..ET via
    the Tj / TJ / ' / " operators (simple-font PDFs — the common case for
    machine-generated documents)."""
    import re

    # one combined scan preserves document order (Tj and TJ interleave in
    # real PDFs — kerned words use TJ, plain runs use Tj)
    op_re = re.compile(
        rb"\(((?:[^()\\]|\\.)*)\)\s*(?:Tj|'|\")"
        rb"|\[((?:[^\]\\]|\\.)*)\]\s*TJ",
        re.DOTALL,
    )
    text_parts: list[str] = []
    for bt_block in re.findall(rb"BT(.*?)ET", content, re.DOTALL):
        for m in op_re.finditer(bt_block):
            if m.group(1) is not None:
                text_parts.append(_pdf_unescape(m.group(1)))
            else:
                for s in re.findall(rb"\(((?:[^()\\]|\\.)*)\)", m.group(2)):
                    text_parts.append(_pdf_unescape(s))
        text_parts.append("\n")
    return "".join(text_parts)


def _pdf_content_runs(content: bytes) -> list[tuple[float, float, str]]:
    """Positioned text runs [(x, y, text)] from a content stream: tracks
    the Td/TD/Tm text-positioning operators alongside Tj/TJ shows — the
    coordinate substrate for table detection (reference analog: OpenParse
    table pipelines, xpacks/llm/parsers.py OpenParse + openparse_utils)."""
    import re

    tok = re.compile(
        rb"\(((?:[^()\\]|\\.)*)\)\s*(?:Tj|'|\")"        # show string
        rb"|\[((?:[^\]\\]|\\.)*)\]\s*TJ"                  # kerned show
        rb"|(-?[\d.]+)\s+(-?[\d.]+)\s+(Td|TD)"           # relative move
        rb"|(-?[\d.]+)\s+(-?[\d.]+)\s+(-?[\d.]+)\s+"
        rb"(-?[\d.]+)\s+(-?[\d.]+)\s+(-?[\d.]+)\s+Tm",   # absolute matrix
        re.DOTALL,
    )
    runs: list[tuple[float, float, str]] = []
    for bt_block in re.findall(rb"BT(.*?)ET", content, re.DOTALL):
        x = y = 0.0
        for m in tok.finditer(bt_block):
            if m.group(1) is not None:
                runs.append((x, y, _pdf_unescape(m.group(1))))
            elif m.group(2) is not None:
                text = "".join(
                    _pdf_unescape(s)
                    for s in re.findall(
                        rb"\(((?:[^()\\]|\\.)*)\)", m.group(2)
                    )
                )
                runs.append((x, y, text))
            elif m.group(5) is not None:
                x += float(m.group(3))
                y += float(m.group(4))
            else:
                x = float(m.group(10))
                y = float(m.group(11))
    return runs


def _runs_to_tables(
    runs: list[tuple[float, float, str]],
    *,
    y_tol: float = 3.0,
    x_tol: float = 6.0,
    min_rows: int = 2,
    min_cols: int = 2,
) -> list[list[list[str]]]:
    """Cluster positioned runs into tables: lines by y, columns by x
    positions that align across consecutive multi-run lines."""
    if not runs:
        return []
    # group runs into lines (descending y = top to bottom)
    lines: list[tuple[float, list[tuple[float, str]]]] = []
    for x, y, text in runs:
        if not text.strip():
            continue
        for ly, cells in lines:
            if abs(ly - y) <= y_tol:
                cells.append((x, text))
                break
        else:
            lines.append((y, [(x, text)]))
    lines.sort(key=lambda l: -l[0])
    tables: list[list[list[str]]] = []
    block: list[list[tuple[float, str]]] = []

    def flush():
        nonlocal block
        if len(block) >= min_rows:
            # columns: union of x starts across the block, merged by x_tol
            xs: list[float] = []
            for row in block:
                for x, _ in row:
                    if not any(abs(x - e) <= x_tol for e in xs):
                        xs.append(x)
            xs.sort()
            if len(xs) >= min_cols:
                table = []
                for row in block:
                    cells = [""] * len(xs)
                    for x, text in sorted(row):
                        ci = min(
                            range(len(xs)), key=lambda i: abs(xs[i] - x)
                        )
                        cells[ci] = (cells[ci] + " " + text).strip()
                    table.append(cells)
                tables.append(table)
        block = []

    for _y, cells in lines:
        if len(cells) >= min_cols:
            block.append(cells)
        else:
            flush()
    flush()
    return tables


def _pdf_text_streams(data: bytes):
    """Yields decoded content streams holding BT/ET text blocks — the one
    shared stream-walk for page text and table extraction. Per stream,
    yields a list of candidate decodings, decompressed candidate FIRST:
    compressed bytes can contain "BT"/"ET" by chance, so consumers should
    stop at the first candidate that produced real content."""
    import re
    import zlib

    for m in re.finditer(rb"(?<!end)stream\r?\n", data):
        start = m.end()
        end = data.find(b"endstream", start)
        if end < 0:
            continue
        raw = data[start:end].rstrip(b"\r\n")
        candidates = []
        try:
            candidates.append(zlib.decompress(raw))
        except zlib.error:
            pass
        candidates.append(raw)
        texty = [c for c in candidates if b"BT" in c and b"ET" in c]
        if texty:
            yield texty


def pdf_tables(data: bytes) -> list[list[list[str]]]:
    """Dependency-free PDF table extraction: positioned text runs
    clustered into aligned rows/columns across every page."""
    tables: list[list[list[str]]] = []
    for candidates in _pdf_text_streams(data):
        for content in candidates:
            runs = _pdf_content_runs(content)
            if runs:
                tables.extend(_runs_to_tables(runs))
                break
    return tables


def _md_cell(text: str) -> str:
    """Markdown-safe cell: literal pipes escape, newlines flatten."""
    return text.replace("|", "\\|").replace("\n", " ").replace("\r", " ")


def _table_to_markdown(table: list[list[str]]) -> str:
    head, *rest = table
    lines = ["| " + " | ".join(_md_cell(c) for c in head) + " |"]
    lines.append("|" + "---|" * len(head))
    for row in rest:
        lines.append("| " + " | ".join(_md_cell(c) for c in row) + " |")
    return "\n".join(lines)


def _builtin_pdf_pages(data: bytes) -> list[str]:
    """Dependency-free PDF text extraction: each content stream holding
    BT/ET text blocks is one page, decoded raw or FlateDecode."""
    pages: list[str] = []
    for candidates in _pdf_text_streams(data):
        for content in candidates:
            text = _pdf_content_text(content)
            if text.strip():
                pages.append(text)
                break
    return pages


class PypdfParser(UDF):
    """reference: parsers.py PypdfParser. Uses pypdf when importable; falls
    back to the built-in minimal extractor (literal-string Tj/TJ text from
    raw or Flate streams) so simple PDFs parse with zero dependencies.

    ``extract_tables=True`` additionally emits one markdown chunk per
    detected table (positioned-run clustering — the dependency-free
    analog of the reference's OpenParse table pipeline,
    parsers.py:53-928 + openparse_utils.py), tagged
    ``{"kind": "table"}`` so retrieval can disclose the source shape."""

    def __init__(
        self,
        apply_text_cleanup: bool = True,
        extract_tables: bool = False,
        **kwargs,
    ):
        try:
            import pypdf  # noqa: F401

            self._have_pypdf = True
        except ImportError:
            self._have_pypdf = False
        self.apply_text_cleanup = apply_text_cleanup
        self.extract_tables = extract_tables
        cleanup = (
            (lambda t: " ".join(t.split())) if apply_text_cleanup else (lambda t: t)
        )

        async def parse(contents) -> list:
            if self._have_pypdf:
                import io

                import pypdf

                reader = pypdf.PdfReader(io.BytesIO(contents))
                out = [
                    (cleanup(page.extract_text() or ""), {"page": i})
                    for i, page in enumerate(reader.pages)
                ]
            else:
                out = [
                    (cleanup(text), {"page": i})
                    for i, text in enumerate(_builtin_pdf_pages(contents))
                ]
            if self.extract_tables:
                for ti, table in enumerate(pdf_tables(contents)):
                    out.append(
                        (
                            _table_to_markdown(table),
                            {"kind": "table", "table": ti},
                        )
                    )
            return out

        super().__init__(parse, return_type=list, deterministic=True)


class ImageParser(UDF):
    """reference: parsers.py ImageParser — vision-LLM image description."""

    def __init__(self, llm=None, parse_prompt: str | None = None, **kwargs):
        if llm is None:
            raise ValueError("ImageParser requires a vision-capable llm")
        self.llm = llm
        self.parse_prompt = parse_prompt or "Describe this image."

        async def parse(contents) -> list:
            import base64

            b64 = base64.b64encode(contents).decode()
            messages = [
                {
                    "role": "user",
                    "content": [
                        {"type": "text", "text": self.parse_prompt},
                        {
                            "type": "image_url",
                            "image_url": {"url": f"data:image/png;base64,{b64}"},
                        },
                    ],
                }
            ]
            text = self.llm.func(messages)
            import inspect

            if inspect.iscoroutine(text):
                text = await text
            return [(text, {})]

        super().__init__(parse, return_type=list, deterministic=True)


class SlideParser(ImageParser):
    """reference: parsers.py SlideParser — vision-LLM slide parsing."""


class MultimodalParser(UDF):
    """Content-sniffing router for mixed corpora — the parser behind the
    multimodal-RAG template (reference: docs/2.developers/7.templates/
    .multimodal-rag/article.py — OpenParse + a vision LLM over documents
    with images/tables, feeding ONE text embedder). The native wiring
    keeps a single text-embedding index: raster images go through the
    vision ``ImageParser`` (the vision LLM's description becomes the
    indexed text), PDFs through ``PypdfParser``, everything else through
    ``ParseUtf8``."""

    _MAGIC = (
        (b"\x89PNG", "image"),
        (b"\xff\xd8\xff", "image"),
        (b"GIF87a", "image"),
        (b"GIF89a", "image"),
        (b"%PDF", "pdf"),
    )

    def __init__(self, llm=None, parse_prompt: str | None = None, **kwargs):
        if llm is None:
            raise ValueError(
                "MultimodalParser requires a vision-capable llm for the "
                "image route"
            )
        image_parser = ImageParser(llm=llm, parse_prompt=parse_prompt)
        pdf_parser = PypdfParser()
        text_parser = ParseUtf8()

        async def parse(contents) -> list:
            import inspect

            data = bytes(contents) if not isinstance(contents, bytes) else contents
            kind = "text"
            for magic, k in MultimodalParser._MAGIC:
                if data.startswith(magic):
                    kind = k
                    break
            # WebP: RIFF container with a WEBP fourcc — plain RIFF alone
            # is also WAV/AVI, which must NOT route to the vision parser
            if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
                kind = "image"
            route = {
                "image": image_parser,
                "pdf": pdf_parser,
                "text": text_parser,
            }[kind]
            res = route.func(data)
            if inspect.iscoroutine(res):
                res = await res
            # tag the modality so retrieval results disclose their source
            return [(text, {**meta, "modality": kind}) for text, meta in res]

        super().__init__(parse, return_type=list, deterministic=True)


class OpenParse(UDF):
    """Structured PDF parsing with the reference's OpenParse arg surface
    (reference: parsers.py:235-395 + openparse_utils.py:1-409) over the
    dependency-free pipeline in xpacks/llm/openparse_utils.py.

    Args:
        table_args: ``{"parsing_algorithm": "llm"|"pymupdf"|"unitable"|
            "table-transformers"[, "llm": chat, "prompt": str]}``. The
            "llm" algorithm routes each detected table through the given
            chat model with the markdown-table prompt; the model names
            select the local positional table detector (same markdown
            output contract). Defaults to the "llm" algorithm with an
            OpenAI gpt-4o chat (requires OPENAI_API_KEY at call time,
            exactly like the reference's default).
        image_args: ``{"parsing_algorithm": "llm", "llm": chat,
            "prompt": str}`` — only "llm" is supported, as in the
            reference.
        parse_images: whether to caption embedded PDF images with the
            vision LLM and index the captions.
        processing_pipeline: "pathway_pdf_default" (SimpleIngestionPipeline),
            "merge_same_page" (SamePageIngestionPipeline), or any object
            with ``process(nodes)``.
        cache_strategy: optional pw.udfs.CacheStrategy.
    """

    def __init__(
        self,
        table_args: dict | None = None,
        image_args: dict | None = None,
        parse_images: bool = False,
        processing_pipeline=None,
        cache_strategy=None,
        **kwargs,
    ):
        import warnings

        from pathway_tpu_torch.xpacks.llm import prompts
        from pathway_tpu_torch.xpacks.llm.openparse_utils import (
            IngestionPipeline,
            PyMuDocumentParser,
            SamePageIngestionPipeline,
            SimpleIngestionPipeline,
        )

        def default_vision_llm():
            from pathway_tpu_torch.xpacks.llm.llms import OpenAIChat

            return OpenAIChat(model="gpt-4o")

        if table_args is None:
            table_args = {
                "parsing_algorithm": "llm",
                "llm": default_vision_llm(),
                "prompt": prompts.DEFAULT_MD_TABLE_PARSE_PROMPT,
            }
        if parse_images:
            if image_args is None:
                warnings.warn(
                    "`parse_images` is set to `True`, but `image_args` is "
                    "not specified, defaulting to `gpt-4o`."
                )
                image_args = {
                    "parsing_algorithm": "llm",
                    "llm": default_vision_llm(),
                    "prompt": prompts.DEFAULT_IMAGE_PARSE_PROMPT,
                }
            elif image_args.get("parsing_algorithm") != "llm":
                raise ValueError(
                    "Image parsing is only supported with LLMs. Either "
                    "change the `parsing_algorithm` to `llm` or set "
                    "`parse_images` to `False`. "
                    f"Given args: {image_args}"
                )
        elif image_args:
            warnings.warn(
                "`parse_images` is set to `False`, but `image_args` is "
                "specified, skipping image parsing."
            )
            image_args = None

        if processing_pipeline is None or (
            processing_pipeline == "pathway_pdf_default"
        ):
            processing_pipeline = SimpleIngestionPipeline()
        elif processing_pipeline == "merge_same_page":
            processing_pipeline = SamePageIngestionPipeline()
        elif isinstance(processing_pipeline, str):
            raise ValueError(
                "Invalid `processing_pipeline` set. It must be either one "
                "of `'pathway_pdf_default'` or `'merge_same_page'`."
            )
        elif not isinstance(processing_pipeline, IngestionPipeline) and (
            not hasattr(processing_pipeline, "process")
        ):
            raise ValueError(
                "`processing_pipeline` must provide a process(nodes) method"
            )

        self.doc_parser = PyMuDocumentParser(
            table_args=table_args,
            image_args=image_args,
            processing_pipeline=processing_pipeline,
        )

        async def parse(contents) -> list:
            nodes = await self.doc_parser.parse(bytes(contents))
            return [
                (
                    node["text"],
                    {"kind": node["kind"], "page": node["page"]},
                )
                for node in nodes
            ]

        # LLM-routed parsing is nondeterministic: retraction replay must
        # reuse the memoized insert-time output or retractions would not
        # cancel their inserts (consistent-deletions semantics)
        deterministic = (
            table_args.get("parsing_algorithm") != "llm"
            and image_args is None
        )
        super().__init__(
            parse, return_type=list, deterministic=deterministic,
            cache_strategy=cache_strategy,
        )
