"""Calibrated dispatch cost model: what the deviceless simulator
charges the virtual clock instead of running a device.

Fit from what a measuring live run already accumulates —
``ServingRuntime.service_log`` (per-dispatch measured seconds, tagged
with the compile count so cold samples are separable) and
``QueryService._sig_history`` (per-signature cumulative trace+compile
seconds) — via ``fit_cost_model(runtime, service)``:

* ``service_s[sig][bucket]``: mean *warm* dispatch seconds per
  (signature digest, bucket size). The sim's steady-state charge.
* ``cold_s[sig]``: mean *cold* dispatch seconds (samples whose
  dispatch paid >=1 compile). Charged the first time the sim sees a
  (sig, bucket) pair — the same first-touch rule as the service's
  compiled-plan cache.
* ``compile_s[sig]``: mean seconds per compile event from the
  service's signature history — the fallback cold charge
  (``warm + compile``) for signatures never observed cold.

``predict(sig, bucket)`` degrades gracefully: exact cell -> per-sig
linear fit over the observed buckets (dispatch cost grows ~linearly in
padded batch rows) -> per-sig mean -> global mean. The fit persists to
versioned JSON **with its residuals**: ``calibration_error`` is
mean |observed - predicted| / mean observed over the warm samples, so
a capacity report can state how far to trust its own curves.

Host-only — fitting and predicting are pure host math.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Optional

from repro_torch.core.obs.trace import sig_digest

COSTMODEL_FORMAT = "repro.cost-model"
COSTMODEL_VERSION = 1


def _mean(xs) -> float:
    xs = list(xs)
    return sum(xs) / len(xs) if xs else 0.0


def _linfit(pts: list[tuple[float, float]]) -> tuple[float, float]:
    """Least-squares (slope, intercept); falls back to a flat line
    through the mean when x has no spread."""
    n = len(pts)
    mx = _mean(p[0] for p in pts)
    my = _mean(p[1] for p in pts)
    sxx = sum((x - mx) ** 2 for x, _ in pts)
    if n < 2 or sxx == 0.0:
        return 0.0, my
    sxy = sum((x - mx) * (y - my) for x, y in pts)
    slope = sxy / sxx
    return slope, my - slope * mx


class CostModel:
    """Fitted per-(signature, bucket) service times + compile times.
    Signatures are digests (``obs.trace.sig_digest``) throughout —
    full erased signatures are huge tuples and the model is meant to
    persist."""

    def __init__(self,
                 service_s: Optional[dict] = None,
                 cold_s: Optional[dict] = None,
                 compile_s: Optional[dict] = None,
                 default_s: float = 0.0,
                 residuals: Optional[list] = None,
                 calibration_error: float = 0.0,
                 samples: int = 0):
        # sig digest -> {bucket(int) -> mean warm seconds}
        self.service_s: dict[str, dict[int, float]] = service_s or {}
        self.cold_s: dict[str, float] = cold_s or {}
        self.compile_s: dict[str, float] = compile_s or {}
        self.default_s = default_s
        # (sig, bucket, observed, predicted) per warm sample
        self.residuals: list[tuple] = residuals or []
        self.calibration_error = calibration_error
        self.samples = samples

    # -- prediction --------------------------------------------------------

    def predict(self, sig: str, bucket: int) -> float:
        """Warm dispatch seconds for one (signature digest, bucket)
        group. Never negative, never NaN — the virtual clock only
        moves forward."""
        cells = self.service_s.get(sig)
        if cells:
            if bucket in cells:
                return max(cells[bucket], 0.0)
            if len(cells) >= 2:
                slope, icept = _linfit(
                    [(float(b), s) for b, s in sorted(cells.items())])
                return max(slope * bucket + icept, 0.0)
            return max(next(iter(cells.values())), 0.0)
        return max(self.default_s, 0.0)

    def predict_cold(self, sig: str, bucket: int) -> float:
        """First-touch dispatch seconds for a (sig, bucket) the plan
        cache has never compiled: an observed cold mean when we have
        one, else warm + per-compile mean."""
        if sig in self.cold_s:
            return max(self.cold_s[sig], 0.0)
        return self.predict(sig, bucket) \
            + max(self.compile_s.get(sig, 0.0), 0.0)

    # -- persistence -------------------------------------------------------

    def to_json(self) -> str:
        doc = {
            "format": COSTMODEL_FORMAT,
            "version": COSTMODEL_VERSION,
            "samples": self.samples,
            "calibration_error": self.calibration_error,
            "default_s": self.default_s,
            # JSON keys are strings; buckets round-trip through int()
            "service_s": {sig: {str(b): s for b, s in cells.items()}
                          for sig, cells in self.service_s.items()},
            "cold_s": self.cold_s,
            "compile_s": self.compile_s,
            "residuals": [list(r) for r in self.residuals],
        }
        return json.dumps(doc, sort_keys=True, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "CostModel":
        doc = json.loads(text)
        if doc.get("format") != COSTMODEL_FORMAT:
            raise ValueError(
                f"not a {COSTMODEL_FORMAT} document: "
                f"format={doc.get('format')!r}")
        if doc.get("version") != COSTMODEL_VERSION:
            raise ValueError(
                f"unknown cost-model version {doc.get('version')!r} "
                f"(this reader understands {COSTMODEL_VERSION})")
        return cls(
            service_s={sig: {int(b): float(s)
                             for b, s in cells.items()}
                       for sig, cells in doc["service_s"].items()},
            cold_s={k: float(v) for k, v in doc["cold_s"].items()},
            compile_s={k: float(v)
                       for k, v in doc["compile_s"].items()},
            default_s=float(doc["default_s"]),
            residuals=[tuple(r) for r in doc.get("residuals", [])],
            calibration_error=float(doc["calibration_error"]),
            samples=int(doc["samples"]))

    def dump(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    def summary(self) -> dict:
        return {
            "signatures": len(self.service_s),
            "cells": sum(len(c) for c in self.service_s.values()),
            "samples": self.samples,
            "default_s": self.default_s,
            "calibration_error": self.calibration_error,
        }


def fit_cost_model(runtime, service=None) -> CostModel:
    """Fit from a measuring runtime's ``service_log`` (requires the
    runtime to have run with ``measure_service_time=True`` — an empty
    log yields a model that predicts the 0.0 default everywhere, which
    a capacity gate should treat as a refusal to calibrate) plus,
    when given, the service's per-signature compile history."""
    warm: dict[tuple[str, int], list[float]] = defaultdict(list)
    cold: dict[str, list[float]] = defaultdict(list)
    for sig, _size, bucket, seconds, compiles in runtime.service_log:
        if compiles > 0:
            cold[sig].append(seconds)
        else:
            warm[(sig, bucket)].append(seconds)

    service_s: dict[str, dict[int, float]] = defaultdict(dict)
    for (sig, bucket), xs in warm.items():
        service_s[sig][bucket] = _mean(xs)

    compile_s: dict[str, float] = {}
    if service is not None:
        for sig, hist in getattr(service, "_sig_history", {}).items():
            if hist.get("compiles"):
                compile_s[sig_digest(sig)] = \
                    hist["compile_s"] / hist["compiles"]

    model = CostModel(
        service_s={k: dict(v) for k, v in service_s.items()},
        cold_s={sig: _mean(xs) for sig, xs in cold.items()},
        compile_s=compile_s,
        default_s=_mean(x for xs in warm.values() for x in xs),
        samples=len(runtime.service_log))

    # residuals of the fitted model over its own warm training samples
    # (cold samples are excluded: compile time is charged separately)
    obs_sum = err_sum = 0.0
    n = 0
    for (sig, bucket), xs in warm.items():
        for x in xs:
            pred = model.predict(sig, bucket)
            model.residuals.append((sig, bucket, x, pred))
            obs_sum += x
            err_sum += abs(x - pred)
            n += 1
    model.calibration_error = (err_sum / obs_sum) if obs_sum else 0.0
    return model
