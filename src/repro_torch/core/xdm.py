"""Columnar XQuery Data Model (XDM) — the device node store.

The paper's VXQuery SAX-parses XML text into binary XDM instances *at
query time* on every node (and measures itself CPU-bound on that parse,
§5.3.1). Accelerators cannot parse text, so we *shred once at ingest*: XML
documents become a structure-of-arrays **node table** plus dictionary
side tables, and every XQuery path/value operation becomes a vectorized
gather/mask over those arrays (DESIGN.md §2).

Node table columns (all int32/float32, one row per XDM node, rows in
document order — so "document order" is simply row order, which is what
makes rule 4.1.1's sort-removal *free* on this representation):

  kind      node kind (DOCUMENT/ELEMENT/ATTRIBUTE/TEXT)
  name      element/attribute name-dictionary id (-1 for text/doc)
  parent    row index of parent node (-1 for document roots)
  doc       document ordinal within the partition
  text_sid  string-dictionary id of the node's string value
  text_num  numeric interpretation of the string value (NaN if none)
  text_date packed yyyymmdd interpretation (-1 if none)

Shred-time *indexes* (the column-store move; replaces per-query pointer
chasing):

  field_map [N, F]   first child of row n with element name f (-1)
  multi     {name: [N, W]} all (up to W) children for names that repeat

Dictionaries are host-side (strings are never device data); device side
carries per-sid derived arrays (e.g. ``ucase_sid`` for upper-case()).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Iterable, Optional

import numpy as np

# Node kinds (XDM)
DOCUMENT, ELEMENT, ATTRIBUTE, TEXT = 0, 1, 2, 3

_NUM_RE = re.compile(r"^-?\d+(\.\d+)?$")
_DATE_RE = re.compile(r"^(\d{4})-(\d{2})-(\d{2})")


class StringDict:
    """Bidirectional string<->int dictionary shared across collections.

    Sharing one dictionary per Database makes string equality (and joins
    on string keys) a pure int compare on device.
    """

    def __init__(self) -> None:
        self._to_id: dict[str, int] = {}
        self._strings: list[str] = []

    def id(self, s: str) -> int:
        i = self._to_id.get(s)
        if i is None:
            i = len(self._strings)
            self._to_id[s] = i
            self._strings.append(s)
        return i

    def lookup(self, s: str) -> int:
        """Id if present else -2 (never matches any stored sid)."""
        return self._to_id.get(s, -2)

    def str(self, i: int) -> str:
        return self._strings[i]

    def __len__(self) -> int:
        return len(self._strings)

    def derived_arrays(self) -> dict[str, np.ndarray]:
        """Per-sid device side tables: uppercase map, numeric, date."""
        # Intern every uppercase form first (append-only, so ids of
        # existing strings are stable) — otherwise upper-case() of a
        # string whose uppercase was never stored could collide with
        # an absent-constant sentinel.
        for s in list(self._strings):
            self.id(s.upper())
        n = len(self._strings)
        ucase = np.asarray([self._to_id[s.upper()] for s in self._strings],
                           np.int32)
        num = np.full(n, np.nan, np.float32)
        date = np.full(n, -1, np.int32)
        for i, s in enumerate(self._strings):
            if _NUM_RE.match(s):
                num[i] = float(s)
            m = _DATE_RE.match(s)
            if m:
                y, mo, d = int(m.group(1)), int(m.group(2)), int(m.group(3))
                date[i] = y * 10000 + mo * 100 + d
        # lexicographic rank per sid: string ORDER BY keys (and the
        # grouping-key tiebreak of ordered group-by output) compare by
        # rank on device, matching host-side str comparison exactly
        # (numpy unicode order == python code-point order)
        rank = np.empty(n, np.int32)
        rank[np.argsort(np.asarray(self._strings))] = np.arange(
            n, dtype=np.int32)
        return {"ucase_sid": ucase, "num_of_sid": num,
                "date_of_sid": date, "rank_of_sid": rank}


def pack_date(y: int, m: int, d: int) -> int:
    return y * 10000 + m * 100 + d


@dataclasses.dataclass
class NodeTable:
    """One partition's shredded nodes (numpy, converted to jnp at exec)."""
    kind: np.ndarray        # [N] int32
    name: np.ndarray        # [N] int32
    parent: np.ndarray      # [N] int32
    doc: np.ndarray         # [N] int32
    text_sid: np.ndarray    # [N] int32
    text_num: np.ndarray    # [N] float32
    text_date: np.ndarray   # [N] int32
    field_map: np.ndarray   # [N, F] int32
    multi: dict[str, np.ndarray]  # name -> [N, W] int32

    @property
    def num_nodes(self) -> int:
        return int(self.kind.shape[0])

    def tag_counts(self) -> dict[int, int]:
        """Node count per element/attribute name id — the per-tag
        statistics cap pre-sizing keys on (a path /a/b/c can match at
        most count(name == c) rows)."""
        named = (self.kind == ELEMENT) | (self.kind == ATTRIBUTE)
        ids = self.name[named & (self.name >= 0)]
        if ids.size == 0:
            return {}
        counts = np.bincount(ids)
        return {int(i): int(c) for i, c in enumerate(counts) if c > 0}

    def tag_value_pairs(self) -> np.ndarray:
        """Distinct (name id, text sid) pairs of this partition's
        named nodes — the raw material for per-tag distinct-key
        cardinality statistics (group-by segment pre-sizing: a key
        ``$r/c`` has at most distinct(text of tag c) groups)."""
        named = (self.kind == ELEMENT) | (self.kind == ATTRIBUTE)
        mask = named & (self.name >= 0) & (self.text_sid >= 0)
        if not np.any(mask):
            return np.zeros((0, 2), np.int64)
        pairs = np.stack([self.name[mask], self.text_sid[mask]],
                         axis=1).astype(np.int64)
        return np.unique(pairs, axis=0)

    def pad_to(self, n: int) -> "NodeTable":
        cur = self.num_nodes
        if cur == n:
            return self
        assert cur < n, (cur, n)
        pad = n - cur

        def p1(a, fill):
            return np.concatenate(
                [a, np.full((pad,) + a.shape[1:], fill, a.dtype)])

        return NodeTable(
            kind=p1(self.kind, -1), name=p1(self.name, -1),
            parent=p1(self.parent, -1), doc=p1(self.doc, -1),
            text_sid=p1(self.text_sid, -1),
            text_num=p1(self.text_num, np.nan),
            text_date=p1(self.text_date, -1),
            field_map=p1(self.field_map, -1),
            multi={k: p1(v, -1) for k, v in self.multi.items()})


class Shredder:
    """Streaming SAX-style shredder: XML text -> NodeTable rows.

    This is the ingest-time analogue of the paper's runtime SAX parse.
    ``feed_document`` accepts a parsed-event stream; ``shred_xml`` runs an
    actual expat SAX parse (used by ingest benchmarks to measure the cost
    the paper measured).
    """

    def __init__(self, names: "NameDict", sdict: StringDict,
                 multi_names: Iterable[str] = ()) -> None:
        self.names = names
        self.sdict = sdict
        self.multi_names = tuple(multi_names)
        self.kind: list[int] = []
        self.name: list[int] = []
        self.parent: list[int] = []
        self.doc: list[int] = []
        self.text: list[str | None] = []
        self._doc_count = 0

    def _add(self, kind: int, name: int, parent: int, text: str | None
             ) -> int:
        i = len(self.kind)
        self.kind.append(kind)
        self.name.append(name)
        self.parent.append(parent)
        self.doc.append(self._doc_count)
        self.text.append(text)
        return i

    def begin_document(self) -> int:
        return self._add(DOCUMENT, -1, -1, None)

    def element(self, name: str, parent: int, text: str | None = None
                ) -> int:
        return self._add(ELEMENT, self.names.id(name), parent, text)

    def end_document(self) -> None:
        self._doc_count += 1

    def shred_xml(self, xml_text: str) -> None:
        """Actual SAX parse of an XML document string (expat)."""
        import xml.parsers.expat as expat
        stack = [self.begin_document()]
        chars: list[list[str]] = [[]]

        def start(name, attrs):
            i = self.element(name, stack[-1])
            stack.append(i)
            chars.append([])
            for k, v in attrs.items():
                self._add(ATTRIBUTE, self.names.id("@" + k), i, v)

        def end(name):
            i = stack.pop()
            txt = "".join(chars.pop()).strip()
            if txt:
                self.text[i] = txt

        def cdata(data):
            chars[-1].append(data)

        p = expat.ParserCreate()
        p.StartElementHandler = start
        p.EndElementHandler = end
        p.CharacterDataHandler = cdata
        p.Parse(xml_text, True)
        self.end_document()

    def finish(self) -> NodeTable:
        n = len(self.kind)
        kind = np.asarray(self.kind, np.int32)
        name = np.asarray(self.name, np.int32)
        parent = np.asarray(self.parent, np.int32)
        doc = np.asarray(self.doc, np.int32)
        text_sid = np.full(n, -1, np.int32)
        text_num = np.full(n, np.nan, np.float32)
        text_date = np.full(n, -1, np.int32)
        for i, t in enumerate(self.text):
            if t is None:
                continue
            text_sid[i] = self.sdict.id(t)
            if _NUM_RE.match(t):
                text_num[i] = float(t)
            m = _DATE_RE.match(t)
            if m:
                text_date[i] = pack_date(int(m.group(1)), int(m.group(2)),
                                         int(m.group(3)))
        # --- shred-time indexes ---
        nf = len(self.names)
        field_map = np.full((n, nf), -1, np.int32)
        multi_w: dict[str, int] = {m: 0 for m in self.multi_names}
        counts: dict[tuple[int, int], int] = {}
        for i in range(n):
            par = parent[i]
            if par < 0 or kind[i] != ELEMENT and kind[i] != ATTRIBUTE:
                continue
            f = name[i]
            if field_map[par, f] == -1:
                field_map[par, f] = i
            c = counts.get((par, f), 0) + 1
            counts[(par, f)] = c
            nm = self.names.str(f)
            if nm in multi_w:
                multi_w[nm] = max(multi_w[nm], c)
        multi: dict[str, np.ndarray] = {}
        for nm in self.multi_names:
            w = max(multi_w[nm], 1)
            arr = np.full((n, w), -1, np.int32)
            fill = np.zeros(n, np.int32)
            f = self.names.lookup(nm)
            for i in range(n):
                par = parent[i]
                if par >= 0 and name[i] == f:
                    arr[par, fill[par]] = i
                    fill[par] += 1
            multi[nm] = arr
        return NodeTable(kind=kind, name=name, parent=parent, doc=doc,
                         text_sid=text_sid, text_num=text_num,
                         text_date=text_date, field_map=field_map,
                         multi=multi)


class NameDict(StringDict):
    """Element/attribute-name dictionary (small; indexes field_map)."""


@dataclasses.dataclass
class CollectionStats:
    """Build-time statistics for one collection: the executor runs one
    local function per partition, so per-partition caps (scan/unnest)
    are a max over partitions, while the group-by segment space is
    global — ``tag_distinct`` counts distinct text values across ALL
    partitions (a group exists once no matter how many partitions
    contribute rows to it)."""
    max_nodes: int                  # largest unpadded partition
    tag_max: dict[int, int]         # name id -> max per-partition count
    tag_distinct: dict[int, int] = dataclasses.field(
        default_factory=dict)       # name id -> global distinct values

    def path_match_bound(self, names: "NameDict",
                         steps: tuple[str, ...]) -> Optional[int]:
        """Upper bound on per-partition matches of a child path ending
        in ``steps[-1]``. A tag absent from the (shared, append-only)
        name dictionary — or never seen in this collection — matches
        nothing, so 0 is exact there; an empty path means the whole
        table."""
        if not steps:
            return self.max_nodes
        f = names.lookup(steps[-1])
        if f < 0:
            return 0
        return self.tag_max.get(f, 0)

    def group_key_bound(self, names: "NameDict", tag: str) -> int:
        """Exact global distinct-value count for grouping keys drawn
        from ``tag`` children: the number of group-by segments a key
        ``.../tag`` can produce over this collection. 0 for a tag that
        is absent (or valueless) here — it contributes no groups."""
        f = names.lookup(tag)
        if f < 0:
            return 0
        return self.tag_distinct.get(f, 0)


def collection_stats(partitions: list["NodeTable"]) -> CollectionStats:
    tag_max: dict[int, int] = {}
    for t in partitions:
        for f, c in t.tag_counts().items():
            tag_max[f] = max(tag_max.get(f, 0), c)
    # distinct text values per tag, global: union the per-partition
    # (name, sid) pair sets before counting
    all_pairs = [t.tag_value_pairs() for t in partitions]
    pairs = np.unique(np.concatenate(all_pairs, axis=0), axis=0) \
        if all_pairs else np.zeros((0, 2), np.int64)
    tag_distinct: dict[int, int] = {}
    if pairs.size:
        tags, counts = np.unique(pairs[:, 0], return_counts=True)
        tag_distinct = {int(f): int(c) for f, c in zip(tags, counts)}
    return CollectionStats(
        max_nodes=max(t.num_nodes for t in partitions),
        tag_max=tag_max, tag_distinct=tag_distinct)


@dataclasses.dataclass
class Collection:
    """A partitioned collection: list of NodeTables, one per partition.

    Mirrors the paper's "XML documents partitioned evenly throughout a
    cluster"; partition p lives on mesh data-slice p at execution.
    """
    name: str
    partitions: list[NodeTable]

    def padded_width(self) -> int:
        """Nmax of ``padded``: the largest partition, rounded up to a
        multiple of 128 for alignment."""
        nmax = max(t.num_nodes for t in self.partitions)
        return int(math.ceil(nmax / 128) * 128)

    def padded(self) -> NodeTable:
        """Stack partitions into [P, Nmax] arrays (SPMD-ready)."""
        nmax = self.padded_width()
        tables = [t.pad_to(nmax) for t in self.partitions]

        def stack(get):
            return np.stack([get(t) for t in tables])

        # repeated-field widths can differ across partitions (an empty
        # partition saw fewer repeats): pad W to the max before stacking
        multi = {}
        for k in tables[0].multi:
            w = max(t.multi[k].shape[1] for t in tables)

            def widen(a):
                if a.shape[1] == w:
                    return a
                pad = np.full((a.shape[0], w - a.shape[1]), -1, a.dtype)
                return np.concatenate([a, pad], axis=1)

            multi[k] = np.stack([widen(t.multi[k]) for t in tables])
        return NodeTable(
            kind=stack(lambda t: t.kind), name=stack(lambda t: t.name),
            parent=stack(lambda t: t.parent), doc=stack(lambda t: t.doc),
            text_sid=stack(lambda t: t.text_sid),
            text_num=stack(lambda t: t.text_num),
            text_date=stack(lambda t: t.text_date),
            field_map=stack(lambda t: t.field_map), multi=multi)


class Database:
    """All collections + shared dictionaries for one query context."""

    def __init__(self) -> None:
        self.names = NameDict()
        self.strings = StringDict()
        self.collections: dict[str, Collection] = {}
        self.stats: dict[str, CollectionStats] = {}

    def add_collection(self, name: str, tables: list[NodeTable]) -> None:
        self.collections[name] = Collection(name, tables)
        # statistics are gathered once at build time; the query service
        # pre-sizes capacities from them (first-shot caps close to right)
        self.stats[name] = collection_stats(tables)

    def collection(self, name: str) -> Collection:
        if name not in self.collections:
            raise KeyError(f"unknown collection {name!r}; "
                           f"known: {sorted(self.collections)}")
        return self.collections[name]

    def num_partitions(self, name: str) -> int:
        return len(self.collection(name).partitions)

    def derived(self) -> dict[str, np.ndarray]:
        return self.strings.derived_arrays()


# the per-partition arrays of a NodeTable, in field order (``multi``
# is a dict of [N, W] arrays, the rest are [N] or [N, F])
NODE_ARRAYS = ("kind", "name", "parent", "doc", "text_sid", "text_num",
               "text_date", "field_map", "multi")


def database_from_arrays(names: list[str], strings: list[str],
                         collections: dict[str, list[dict[str, Any]]]
                         ) -> Database:
    """Rebuild a Database from plain data: the name and string
    dictionaries in id order, and per collection one dict of numpy
    node-table arrays (``NODE_ARRAYS``) per partition. Statistics are
    recomputed from the arrays. This is how a database shredded
    elsewhere — by another implementation of this data model — is
    carried over with every id unchanged."""
    db = Database()
    for nm in names:
        db.names.id(nm)
    for s in strings:
        db.strings.id(s)
    if len(db.names) != len(names) or len(db.strings) != len(strings):
        raise ValueError("dictionaries must not repeat an entry")
    for cname, parts in collections.items():
        tables = []
        for arrs in parts:
            missing = set(NODE_ARRAYS) - set(arrs)
            if missing:
                raise ValueError(f"collection {cname!r}: partition lacks "
                                 f"{sorted(missing)}")
            tables.append(NodeTable(
                kind=np.asarray(arrs["kind"], np.int32),
                name=np.asarray(arrs["name"], np.int32),
                parent=np.asarray(arrs["parent"], np.int32),
                doc=np.asarray(arrs["doc"], np.int32),
                text_sid=np.asarray(arrs["text_sid"], np.int32),
                text_num=np.asarray(arrs["text_num"], np.float32),
                text_date=np.asarray(arrs["text_date"], np.int32),
                field_map=np.asarray(arrs["field_map"], np.int32),
                multi={k: np.asarray(v, np.int32)
                       for k, v in arrs["multi"].items()}))
        db.add_collection(cname, tables)
    return db


def database_to_arrays(db) -> tuple[list[str], list[str],
                                    dict[str, list[dict[str, Any]]]]:
    """The inverse of ``database_from_arrays``: a Database's dictionaries
    and node tables as plain lists and numpy arrays. Reads only the
    data-model interface (dictionaries, collections, partitions), so it
    exports any implementation of this data model."""
    names = [db.names.str(i) for i in range(len(db.names))]
    strings = [db.strings.str(i) for i in range(len(db.strings))]
    colls = {name: [{k: getattr(t, k) for k in NODE_ARRAYS}
                    for t in c.partitions]
             for name, c in db.collections.items()}
    return names, strings, colls
