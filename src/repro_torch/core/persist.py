"""Disk-backed persistent compiled-plan cache.

The port of the JAX package's ``core/persist.py``. The serving tier's
in-memory plan cache (service.py) dies with the process; this module
lets a restarted ``QueryService`` load its compiled variants from disk
instead of compiling them, when — and only when — the environment that
produced them still holds.

What an entry holds. Torch has no executable to serialize: a compiled
plan here is an eager closure over the device tables
(``Executor.compile``). So an entry holds what rebuilds the closure
without compiling: the plan as compiled (parameter-lifted), its
resolved ``ExecConfig``, its ``param_specs`` and batch width, and the
column schema that a run fills in (the service stores an entry after
the compiled plan's first run; ``compile(aot=True)`` runs it at
compile time). ``Executor.load`` rebuilds the closure from them; that
counts as a load, not as a compile. A load therefore saves the host's
lift and kernel-policy resolution, not an XLA compile: almost no time
today. The module exists so that the API, the counters and the failure
rules behave as the reference's do.

Layout: one file per entry under the cache directory, named by the
SHA-256 of the *entry key* — the parameter-erased plan signature
(prepared.py) combined with everything else the in-memory cache keys
on: the resolved config, executor mode, partition count and batch
width. The **environment fingerprint** (torch and CUDA versions, the
device name and count, the process group's size, the partition count,
a digest of the CUDA kernel sources, and a digest of the database's
tables and dictionaries) is deliberately NOT part of the file name: a
stale entry must be *found* and *invalidated* — visible in the
``persist_invalidations`` counter — not silently missed, so a
mismatched environment is provably never served.

File format (all-or-nothing, torn writes detected):

    MAGIC(8) | sha256(body)(32) | body = pickle({fingerprint, key,
                                                 schema, plan, config,
                                                 param_specs, batch})

Every failure mode — missing file, torn write, checksum mismatch,
unpicklable body, foreign format version, fingerprint mismatch, a plan
that is not the one asked for — degrades to a normal compile;
corruption deletes the entry so the next lookup is a clean miss.
Writes are atomic (temp file + ``os.replace``), and a ``max_bytes``
bound prunes oldest-first by modification time. Entries are pickles:
point ``persist_dir`` only at a directory this program's services
write.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
from pathlib import Path
from typing import Optional

import torch

#: bump when the entry layout changes — old files then read as
#: fingerprint mismatches (invalidated, recompiled, overwritten)
FORMAT_VERSION = 1

_MAGIC = b"RPLANC01"
_SUFFIX = ".plan"

#: the CUDA kernel sources: the built kernels decide the results
CSRC_DIR = Path(__file__).resolve().parents[1] / "kernels" / "csrc"


# ---------------------------------------------------------------------------
# Fingerprinting: what must match for a cached plan to be safe
# ---------------------------------------------------------------------------


def csrc_digest() -> str:
    """SHA-256 over the names and bytes of every kernel source in
    ``CSRC_DIR`` (``*.cu`` and the ``*.cuh`` they include)."""
    h = hashlib.sha256()
    for f in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(b"\x00")
        h.update(f.read_bytes())
    return h.hexdigest()


def env_fingerprint(device: Optional[torch.device] = None,
                    world_size: int = 1) -> dict:
    """Process-environment half of the fingerprint: everything that
    changes what a plan computes without appearing in its signature or
    config — the torch and CUDA versions, the device, the process
    group's size, and the kernel sources."""
    device = torch.device(device or "cpu")
    on_cuda = device.type == "cuda"
    return {
        "format": FORMAT_VERSION,
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "",
        "device_type": device.type,
        "device_name": (torch.cuda.get_device_name(device) if on_cuda
                        else "cpu"),
        "device_count": torch.cuda.device_count() if on_cuda else 1,
        "world_size": world_size,
        "csrc": csrc_digest(),
    }


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def db_digest(db, tables: dict) -> str:
    """Digest of everything the database bakes into a plan's run:
    table shapes/dtypes plus the full name- and string-dictionary
    contents — sids and name ids are compiled into constants (predicate
    comparisons, path steps, segment spaces), so two databases that
    disagree on any dictionary entry must never share plans. ``tables``
    is a nested dict of arrays or tensors (``host_tables``); their
    content is excluded: reloading same-shaped data is the restart case
    this cache exists for."""
    h = hashlib.sha256()
    for path, leaf in _leaves(tables):
        h.update(repr((path, tuple(leaf.shape), str(leaf.dtype))).encode())
    for dic in (db.names, db.strings):
        h.update(b"\x00dict")
        for s in dic._strings:
            h.update(s.encode("utf-8", "surrogatepass"))
            h.update(b"\x00")
    return h.hexdigest()


def host_tables(db) -> dict:
    """The host arrays ``physical.device_tables`` uploads (all P
    partitions): what ``db_digest`` reads, without touching a device."""
    out = {"__derived__": db.derived()}
    for name, coll in db.collections.items():
        t = coll.padded()
        out[name] = {"kind": t.kind, "name": t.name, "parent": t.parent,
                     "text_sid": t.text_sid, "text_num": t.text_num,
                     "text_date": t.text_date, "field_map": t.field_map,
                     "multi": dict(t.multi)}
    return out


def service_fingerprint(db, tables: dict, mode: str, num_partitions: int,
                        device: Optional[torch.device] = None,
                        world_size: int = 1) -> dict:
    """The full fingerprint a QueryService stamps on / checks against
    every entry."""
    fp = env_fingerprint(device, world_size)
    fp["mode"] = mode
    fp["partitions"] = num_partitions
    fp["db"] = db_digest(db, tables)
    return fp


def entry_key(sig: str, cfg, mode: str, num_partitions: int,
              batch: Optional[int]) -> str:
    """Stable content address of one compiled variant — the on-disk
    mirror of the in-memory cache key (minus the profile flag: profile
    variants are never persisted). ``cfg`` must be the *resolved*
    config (kernel tri-states pinned), so a policy flip produces a
    different address instead of a false hit."""
    raw = repr((sig, cfg.cap_key(), mode, num_partitions, batch))
    return hashlib.sha256(raw.encode()).hexdigest()


# ---------------------------------------------------------------------------
# Compiled plans <-> entries
# ---------------------------------------------------------------------------


def pack_compiled(cp) -> Optional[dict]:
    """CompiledPlan -> persistable entry body, or None when there is
    nothing to store: a donated (one-shot) or profile plan, or one
    whose schema no run has filled in yet."""
    if cp.donated or cp.profile_meta is not None or not cp.schema:
        return None
    return {"schema": dict(cp.schema), "plan": cp.plan,
            "config": cp.config, "param_specs": tuple(cp.param_specs),
            "batch": cp.batch}


def load_compiled(executor, entry: dict, plan, mode: str, mesh=None):
    """Entry body -> a CompiledPlan rebuilt by ``executor.load`` with the
    caller's ``plan`` object. Raises on an entry that does not describe
    ``plan`` — callers treat that as an invalidation."""
    if repr(entry["plan"]) != repr(plan):
        raise ValueError("the entry holds another plan")
    return executor.load(plan, entry["schema"], entry["config"], mode=mode,
                         mesh=mesh, param_specs=entry["param_specs"],
                         batch=entry["batch"])


# ---------------------------------------------------------------------------
# The on-disk cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DiskCacheInfo:
    """Host-side observability snapshot of the cache directory."""
    entries: int
    bytes: int
    path: str


class PlanDiskCache:
    """Checksummed, fingerprint-checked, size-bounded directory of
    compiled-plan entries. Thread-compatible in the repo's single-writer
    serving model; crash-safe via atomic renames."""

    def __init__(self, path: str,
                 max_bytes: Optional[int] = None) -> None:
        self.path = path
        self.max_bytes = max_bytes
        os.makedirs(path, exist_ok=True)

    def _file(self, key: str) -> str:
        return os.path.join(self.path, key + _SUFFIX)

    # -- read ------------------------------------------------------------

    def lookup(self, key: str,
               fingerprint: dict) -> tuple[str, Optional[dict]]:
        """-> ("hit", entry) | ("miss", None) | ("invalid", None).

        "invalid" covers every unsafe-to-serve state — torn write,
        checksum mismatch, foreign format, fingerprint mismatch — and
        DELETES the entry, so the persistent tier degrades to a normal
        compile (which re-stores a fresh entry) rather than crashing or
        serving a wrong plan."""
        f = self._file(key)
        try:
            with open(f, "rb") as fh:
                blob = fh.read()
        except OSError:
            return "miss", None
        body = self._validate(blob, key, fingerprint)
        if body is None:
            self.invalidate(key)
            return "invalid", None
        return "hit", body

    @staticmethod
    def _validate(blob: bytes, key: str,
                  fingerprint: dict) -> Optional[dict]:
        if len(blob) < len(_MAGIC) + 32 or not blob.startswith(_MAGIC):
            return None
        digest = blob[len(_MAGIC):len(_MAGIC) + 32]
        body_bytes = blob[len(_MAGIC) + 32:]
        if hashlib.sha256(body_bytes).digest() != digest:
            return None
        try:
            body = pickle.loads(body_bytes)
        except Exception:
            return None
        if not isinstance(body, dict) or body.get("key") != key:
            return None
        if body.get("fingerprint") != fingerprint:
            return None
        return body

    # -- write -----------------------------------------------------------

    def store(self, key: str, fingerprint: dict,
              entry: dict) -> Optional[int]:
        """Atomically persist one entry; returns the number of older
        entries pruned to honor ``max_bytes`` (None when the store
        itself failed — a read-only or full disk must not take serving
        down with it)."""
        body = dict(entry)
        body["key"] = key
        body["fingerprint"] = fingerprint
        body_bytes = pickle.dumps(body, protocol=pickle.HIGHEST_PROTOCOL)
        blob = _MAGIC + hashlib.sha256(body_bytes).digest() + body_bytes
        tmp = self._file(key) + f".tmp-{os.getpid()}"
        try:
            with open(tmp, "wb") as fh:
                fh.write(blob)
            os.replace(tmp, self._file(key))
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            return None
        return self._prune()

    def invalidate(self, key: str) -> None:
        try:
            os.remove(self._file(key))
        except OSError:
            pass

    def _prune(self) -> int:
        """Drop oldest entries (by mtime — LRU-ish without touching
        reads) until the directory fits ``max_bytes``."""
        if self.max_bytes is None:
            return 0
        ents = []
        for name in os.listdir(self.path):
            if not name.endswith(_SUFFIX):
                continue
            f = os.path.join(self.path, name)
            try:
                st = os.stat(f)
            except OSError:
                continue
            ents.append((st.st_mtime, st.st_size, f))
        total = sum(sz for _, sz, _ in ents)
        pruned = 0
        for _, sz, f in sorted(ents):
            if total <= self.max_bytes:
                break
            try:
                os.remove(f)
            except OSError:
                continue
            total -= sz
            pruned += 1
        return pruned

    # -- observability ---------------------------------------------------

    def info(self) -> DiskCacheInfo:
        n = size = 0
        for name in os.listdir(self.path):
            if name.endswith(_SUFFIX):
                f = os.path.join(self.path, name)
                try:
                    size += os.stat(f).st_size
                except OSError:
                    continue
                n += 1
        return DiskCacheInfo(entries=n, bytes=size, path=self.path)


__all__: list[str] = [
    "FORMAT_VERSION", "PlanDiskCache", "DiskCacheInfo", "csrc_digest",
    "env_fingerprint", "db_digest", "host_tables", "service_fingerprint",
    "entry_key", "pack_compiled", "load_compiled",
]
