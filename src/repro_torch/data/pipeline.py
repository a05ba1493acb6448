"""LM data pipeline, ported from ``repro/data/pipeline.py``: the training
driver's synthetic batches, and the corpus filter expressed through the
paper's algebra.

``synthetic_lm_batches`` is the training driver's default source:
deterministic token streams with next-token labels (language modeling
shift), shaped for every frontend (tokens / frames / patches). The
draws are numpy's, the same as the JAX package's from the same seed;
the batches are tensors on the requested device (``None``: the GPU).

``corpus_query`` builds a document filter over a token-corpus metadata
collection: a DATASCAN with predicate pushdown through the same
translator + rewrite pipeline the weather queries use, so rule 4.2.1
(scan pushdown) and 4.2.2 (two-step stats aggregation) fire on LM-side
workloads too. Host-only, over the port's own ``xdm``.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.core.executor import resolve_device
from repro_torch.models.model import ModelConfig


def batch_at(cfg: ModelConfig, step: int, *, batch: int, seq: int,
             seed: int = 0, device=None) -> dict:
    """Deterministic batch for a given step index. Step-indexed (not a
    stateful stream) so checkpoint resume replays the exact same data
    order — a requirement the resume test enforces."""
    return next(synthetic_lm_batches(cfg, batch=batch, seq=seq,
                                     seed=(seed << 20) ^ step,
                                     device=device))


def synthetic_lm_batches(cfg: ModelConfig, *, batch: int, seq: int,
                         seed: int = 0, device=None) -> Iterator[dict]:
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    def f32(a):
        return torch.as_tensor(a, device=device)

    while True:
        if cfg.frontend == "frames":
            frames = rng.normal(size=(batch, seq, cfg.frontend_dim)
                                ).astype(np.float32)
            labels = rng.integers(0, cfg.vocab_size, (batch, seq))
            yield {"frames": f32(frames), "labels": i32(labels)}
        elif cfg.frontend == "patches":
            npch = max(seq // 4, 1)
            ntok = seq - npch
            toks = rng.integers(0, cfg.vocab_size, (batch, ntok))
            patches = rng.normal(size=(batch, npch, cfg.frontend_dim)
                                 ).astype(np.float32)
            pos = np.broadcast_to(np.arange(seq), (3, batch, seq))
            yield {"tokens": i32(toks), "patches": f32(patches),
                   "positions": i32(pos),
                   "labels": i32(rng.integers(0, cfg.vocab_size,
                                              (batch, ntok)))}
        else:
            toks = rng.integers(1, cfg.vocab_size, (batch, seq + 1))
            yield {"tokens": i32(toks[:, :-1]), "labels": i32(toks[:, 1:])}


# ---------------------------------------------------------------------------
# Corpus filtering through the paper's compiler
# ---------------------------------------------------------------------------

def corpus_query(min_quality: float) -> str:
    """Document-filter query over a shredded corpus-metadata collection
    (one <doc> element per document: id, quality, lang, tokens)."""
    return f'''
for $d in collection("/corpus")/docCollection/doc
where $d/lang eq "en"
 and decimal(data($d/quality)) gt {min_quality}
return $d
'''


def corpus_stats_query() -> str:
    """Two-step-aggregated token count over the kept documents —
    rule 4.2.2 applies exactly as it does to weather Q3."""
    return '''
sum(
 for $d in collection("/corpus")/docCollection/doc
 where $d/lang eq "en"
 return $d/tokens
)
'''


def build_corpus_database(num_docs: int = 256, num_partitions: int = 4,
                          seed: int = 0):
    """Synthetic corpus-metadata collection in the columnar XDM."""
    from repro_torch.core import xdm
    rng = np.random.default_rng(seed)
    db = xdm.Database()
    for nm in ("docCollection", "doc", "id", "quality", "lang",
               "tokens"):
        db.names.id(nm)
    langs = ["en", "de", "fr"]
    tables = []
    for p in range(num_partitions):
        sh = xdm.Shredder(db.names, db.strings)
        d = sh.begin_document()
        root = sh.element("docCollection", d)
        for i in range(p, num_docs, num_partitions):
            doc = sh.element("doc", root)
            sh.element("id", doc, f"doc-{i:06d}")
            sh.element("quality", doc, f"{rng.random():.3f}")
            sh.element("lang", doc, langs[i % len(langs)])
            sh.element("tokens", doc, str(int(rng.integers(100, 4096))))
        sh.end_document()
        tables.append(sh.finish())
    db.add_collection("/corpus", tables)
    return db
