"""NOAA GHCN-Daily-like weather XML generator + shredders (paper §5.1).

Two ingest paths, differentially tested against each other:

* ``build_database(spec, P)`` — **bulk shredder**: builds the columnar
  node tables directly with vectorized numpy (the production ingest
  path; no per-node Python).
* ``build_database(spec, P, sax=True)`` — renders actual XML text and
  runs the expat SAX shredder (``xdm.Shredder.shred_xml``) — the
  paper's runtime-parse cost, kept measurable in ``benchmarks/ingest``.

Collections (paper §5.2):
  /sensors       dataCollection/data records (date, dataType, station,
                 value)
  /stations      stationCollection/station records (id, displayName,
                 latitude, longitude, locationLabels*)
  /sensors_min   TMIN-only subset (Q8)
  /sensors_max   TMAX-only subset (Q8)

The spec guarantees the paper queries are non-degenerate: station 0 is
Key West (USW00012836, FLORIDA), station 1 is Syracuse (USW00014771,
NEW YORK); every year includes 12-25 and 07-04 readings; WASHINGTON
stations and non-US stations exist.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.core import xdm

STATES = ["FLORIDA", "NEW YORK", "WASHINGTON", "CALIFORNIA", "TEXAS",
          "ARIZONA", "OREGON", "NEVADA", "MONTANA", "KANSAS"]
DATATYPES = ("TMAX", "TMIN", "PRCP", "AWND", "SNOW")


@dataclasses.dataclass(frozen=True)
class WeatherSpec:
    num_stations: int = 20
    years: tuple[int, ...] = (1976, 1999, 2000, 2001, 2003, 2004)
    days_per_year: int = 4          # always includes 12-25 and 07-04
    datatypes: tuple[str, ...] = DATATYPES
    records_per_doc: int = 64
    foreign_every: int = 7          # every k-th station is non-US
    seed: int = 0

    def station_id(self, i: int) -> str:
        if i == 0:
            return "GHCND:USW00012836"   # Key West Intl Airport, FL
        if i == 1:
            return "GHCND:USW00014771"   # Syracuse Hancock Airport, NY
        return f"GHCND:USW9{i:07d}"

    def station_state(self, i: int) -> str:
        if i == 0:
            return "FLORIDA"
        if i == 1:
            return "NEW YORK"
        return STATES[i % len(STATES)]

    def station_is_us(self, i: int) -> bool:
        return i < 2 or (i % self.foreign_every) != self.foreign_every - 1

    def dates(self) -> list[tuple[int, int, int]]:
        """(y, m, d) list; deterministic, includes the paper's dates."""
        fixed = [(12, 25), (7, 4)]
        extra = [(1, 15), (3, 10), (5, 20), (8, 30), (10, 5), (11, 11)]
        mds = (fixed + extra)[:max(self.days_per_year, 2)]
        return [(y, m, d) for y in self.years for (m, d) in mds]


def _date_str(y: int, m: int, d: int) -> str:
    return f"{y:04d}-{m:02d}-{d:02d}T00:00:00.000"


# ---------------------------------------------------------------------------
# Record enumeration (shared by both ingest paths)
# ---------------------------------------------------------------------------

def _make_records(spec: WeatherSpec) -> dict[str, np.ndarray]:
    """Vectorized record synthesis -> arrays indexed by record.

    Values are deterministic hashes of (station, date, type) so both
    ingest paths and any partitioning agree exactly.
    """
    dates = spec.dates()
    nd, ns, nt = len(dates), spec.num_stations, len(spec.datatypes)
    st, di, ty = np.meshgrid(np.arange(ns), np.arange(nd), np.arange(nt),
                             indexing="ij")
    st, di, ty = st.ravel(), di.ravel(), ty.ravel()
    h = (st.astype(np.int64) * 1000003 + di * 7919 + ty * 104729) % 100000
    # per-type value ranges (tenths units, like GHCN)
    base = np.zeros(st.shape[0], np.float32)
    tyname = np.asarray(spec.datatypes)[ty]
    base = np.where(tyname == "TMAX", (h % 700).astype(np.float32) - 100,
                    base)
    base = np.where(tyname == "TMIN", (h % 600).astype(np.float32) - 300,
                    base)
    base = np.where(tyname == "PRCP", (h % 800).astype(np.float32), base)
    base = np.where(tyname == "AWND", (h % 700).astype(np.float32), base)
    base = np.where(tyname == "SNOW", (h % 300).astype(np.float32), base)
    return {"station": st.astype(np.int32), "date": di.astype(np.int32),
            "dtype": ty.astype(np.int32), "value": base}


# ---------------------------------------------------------------------------
# Bulk (vectorized) shredder
# ---------------------------------------------------------------------------

_SENSOR_FIELDS = ("date", "dataType", "station", "value")


def _bulk_sensor_table(spec: WeatherSpec, db: xdm.Database,
                       rec: dict[str, np.ndarray], sel: np.ndarray
                       ) -> xdm.NodeTable:
    """Build one partition's sensor NodeTable without per-node Python."""
    names, sdict = db.names, db.strings
    nm_dc = names.id("dataCollection")
    nm_data = names.id("data")
    nm_f = [names.id(f) for f in _SENSOR_FIELDS]
    nf = len(names)

    dates = spec.dates()
    date_sid = np.asarray([sdict.id(_date_str(*d)) for d in dates],
                          np.int32)
    date_packed = np.asarray([xdm.pack_date(*d) for d in dates], np.int32)
    st_sid = np.asarray([sdict.id(spec.station_id(i))
                         for i in range(spec.num_stations)], np.int32)
    ty_sid = np.asarray([sdict.id(t) for t in spec.datatypes], np.int32)

    r_st = rec["station"][sel]
    r_di = rec["date"][sel]
    r_ty = rec["dtype"][sel]
    r_val = rec["value"][sel]
    nrec = r_st.shape[0]
    rpd = spec.records_per_doc
    ndoc = max((nrec + rpd - 1) // rpd, 1)

    chunks = []
    for d in range(ndoc):
        lo, hi = d * rpd, min((d + 1) * rpd, nrec)
        r = hi - lo
        n = 2 + 5 * r          # DOC, dataCollection, r * (data + 4 fields)
        kind = np.full(n, xdm.ELEMENT, np.int32)
        kind[0] = xdm.DOCUMENT
        name = np.full(n, -1, np.int32)
        name[1] = nm_dc
        parent = np.full(n, -1, np.int32)
        parent[1] = 0
        text_sid = np.full(n, -1, np.int32)
        text_num = np.full(n, np.nan, np.float32)
        text_date = np.full(n, -1, np.int32)
        base = 2 + 5 * np.arange(r)            # "data" element rows
        name[base] = nm_data
        parent[base] = 1
        for k in range(4):
            name[base + 1 + k] = nm_f[k]
            parent[base + 1 + k] = base
        sl = slice(lo, hi)
        text_sid[base + 1] = date_sid[r_di[sl]]
        text_date[base + 1] = date_packed[r_di[sl]]
        text_sid[base + 2] = ty_sid[r_ty[sl]]
        text_sid[base + 3] = st_sid[r_st[sl]]
        text_num[base + 4] = r_val[sl]
        field_map = np.full((n, nf), -1, np.int32)
        field_map[0, nm_dc] = 1
        field_map[1, nm_data] = base[0] if r else -1
        for k in range(4):
            field_map[base, nm_f[k]] = base + 1 + k
        doc = np.zeros(n, np.int32)
        chunks.append((kind, name, parent, doc + d, text_sid, text_num,
                       text_date, field_map))

    cat = [np.concatenate([c[i] for c in chunks]) if chunks[0][i].ndim == 1
           else np.concatenate([c[i] for c in chunks], axis=0)
           for i in range(8)]
    # fix up parents/field_map row offsets across chunks
    offs = np.cumsum([0] + [c[0].shape[0] for c in chunks[:-1]])
    row0 = 0
    kind, name, parent, doc, ts, tn, td, fm = cat
    pos = 0
    for ci, c in enumerate(chunks):
        n = c[0].shape[0]
        slc = slice(pos, pos + n)
        padj = parent[slc]
        parent[slc] = np.where(padj >= 0, padj + offs[ci], padj)
        fadj = fm[slc]
        fm[slc] = np.where(fadj >= 0, fadj + offs[ci], fadj)
        pos += n
    del row0
    return xdm.NodeTable(kind=kind, name=name, parent=parent, doc=doc,
                         text_sid=ts, text_num=tn, text_date=td,
                         field_map=fm, multi={})


def _station_tables(spec: WeatherSpec, db: xdm.Database, parts: int
                    ) -> list[xdm.NodeTable]:
    names, sdict = db.names, db.strings
    tables = []
    for p in range(parts):
        sh = xdm.Shredder(names, sdict, multi_names=("locationLabels",))
        doc = sh.begin_document()
        root = sh.element("stationCollection", doc)
        for i in range(p, spec.num_stations, parts):
            st = sh.element("station", root)
            sh.element("id", st, spec.station_id(i))
            sh.element("displayName", st,
                       f"STATION {i} {spec.station_state(i)} AIRPORT")
            sh.element("latitude", st, f"{25 + (i % 40)}.5")
            sh.element("longitude", st, f"-{70 + (i % 50)}.25")
            lab = sh.element("locationLabels", st)
            sh.element("type", lab, "ST")
            sh.element("id", lab, f"FIPS:{10 + i % len(STATES)}")
            # state display names are mixed-case in NOAA; queries
            # upper-case() them (Q5)
            sh.element("displayName", lab,
                       spec.station_state(i).capitalize())
            lab2 = sh.element("locationLabels", st)
            sh.element("type", lab2, "CNTRY")
            us = spec.station_is_us(i)
            sh.element("id", lab2, "FIPS:US" if us else "FIPS:CA")
            sh.element("displayName", lab2,
                       "United States" if us else "Canada")
        sh.end_document()
        tables.append(sh.finish())
    return tables


# ---------------------------------------------------------------------------
# XML text rendering + SAX ingest (differential / ingest-cost path)
# ---------------------------------------------------------------------------

def sensor_xml_documents(spec: WeatherSpec, sel: np.ndarray,
                         rec: dict[str, np.ndarray]) -> Iterator[str]:
    dates = spec.dates()
    r_st, r_di = rec["station"][sel], rec["date"][sel]
    r_ty, r_val = rec["dtype"][sel], rec["value"][sel]
    rpd = spec.records_per_doc
    for lo in range(0, max(len(r_st), 1), rpd):
        hi = min(lo + rpd, len(r_st))
        out = ["<dataCollection>"]
        for j in range(lo, hi):
            v = r_val[j]
            vtxt = str(int(v)) if float(v).is_integer() else f"{v:.1f}"
            out.append(
                "<data>"
                f"<date>{_date_str(*dates[r_di[j]])}</date>"
                f"<dataType>{spec.datatypes[r_ty[j]]}</dataType>"
                f"<station>{spec.station_id(r_st[j])}</station>"
                f"<value>{vtxt}</value>"
                "</data>")
        out.append("</dataCollection>")
        yield "".join(out)


def _sax_sensor_table(spec: WeatherSpec, db: xdm.Database,
                      rec: dict[str, np.ndarray], sel: np.ndarray
                      ) -> xdm.NodeTable:
    sh = xdm.Shredder(db.names, db.strings)
    for doc in sensor_xml_documents(spec, sel, rec):
        sh.shred_xml(doc)
    return sh.finish()


# ---------------------------------------------------------------------------
# Database assembly
# ---------------------------------------------------------------------------

def build_database(spec: WeatherSpec, num_partitions: int = 4,
                   sax: bool = False) -> xdm.Database:
    db = xdm.Database()
    # intern names in fixed order so both paths agree
    for nm in ("dataCollection", "data", "date", "dataType", "station",
               "value", "stationCollection", "id", "displayName",
               "latitude", "longitude", "locationLabels", "type"):
        db.names.id(nm)
    rec = _make_records(spec)
    nrec = rec["station"].shape[0]
    part_of = np.arange(nrec) % num_partitions   # round-robin, like HDFS
    make = _sax_sensor_table if sax else _bulk_sensor_table

    def sensor_parts(mask_extra=None):
        tables = []
        for p in range(num_partitions):
            sel = part_of == p
            if mask_extra is not None:
                sel = sel & mask_extra
            tables.append(make(spec, db, rec, np.nonzero(sel)[0]))
        return tables

    db.add_collection("/sensors", sensor_parts())
    tyname = np.asarray(spec.datatypes)[rec["dtype"]]
    db.add_collection("/sensors_min", sensor_parts(tyname == "TMIN"))
    db.add_collection("/sensors_max", sensor_parts(tyname == "TMAX"))
    db.add_collection("/stations", _station_tables(spec, db,
                                                   num_partitions))
    return db
