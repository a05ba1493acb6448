"""Multi-tenant serving workloads: constant-variants of the paper's
query templates (Q1-Q8) and the group-by templates (Q9/Q10 + a
Q6-style grouped join).

Every variant of one template parses and optimizes to the *same* plan
shape — only the literals differ — so the prepared-query subsystem
(prepared.py) erases them to one signature and the whole workload
compiles once per template. This module is the shared source of those
variants for tests (parameter-sharing regression coverage, the
differential harness's binding grids) and benchmarks
(compile-amortized QPS in serving_benchmarks.py). It also generates
the serving runtime's open-loop **multi-tenant traffic**
(``make_tenant_traffic``): per-tenant Poisson arrivals with per-tenant
signature mixes over Q1-Q10, deterministic per seed.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

DATES = ((12, 25), (7, 4), (12, 25), (7, 4))
DTYPES = ("TMAX", "TMIN", "PRCP", "AWND", "SNOW")
STATES = ("WASHINGTON", "FLORIDA", "NEW YORK", "CALIFORNIA", "TEXAS")


def q1_variant(station: str, year: int, month: int, day: int) -> str:
    """Q1 template: one station's readings on one calendar date."""
    return f'''
for $r in collection("/sensors")/dataCollection/data
let $datetime := dateTime(data($r/date))
where $r/station eq "{station}"
 and year-from-dateTime($datetime) ge {year}
 and month-from-dateTime($datetime) eq {month}
 and day-from-dateTime($datetime) eq {day}
return $r
'''


def q2_variant(datatype: str, threshold: float) -> str:
    """Q2 template: readings of one type above a threshold."""
    return f'''
for $r in collection("/sensors")/dataCollection/data
where $r/dataType eq "{datatype}"
and decimal(data($r/value)) gt {threshold}
return $r
'''


def q3_variant(station: str, datatype: str, year: int,
               divisor: int = 10) -> str:
    """Q3 template: scaled yearly sum of one station's readings."""
    return f'''
sum(
 for $r in collection("/sensors")/dataCollection/data
 where $r/station eq "{station}"
 and $r/dataType eq "{datatype}"
 and year-from-dateTime(dateTime(data($r/date))) eq {year}
 return $r/value
) div {divisor}
'''


def q4_variant(datatype: str, divisor: int = 10) -> str:
    """Q4 template: scaled maximum over one reading type."""
    return f'''
max(
 for $r in collection("/sensors")/dataCollection/data
 where $r/dataType eq "{datatype}"
 return $r/value
) div {divisor}
'''


def q5_variant(state: str, datestr: str) -> str:
    """Q5 template: one state's readings on one timestamp."""
    return f'''
for $s in collection("/stations")/stationCollection/station
for $r in collection("/sensors")/dataCollection/data
where $s/id eq $r/station
 and (some $x in $s/locationLabels satisfies (
 $x/type eq "ST" and
 upper-case(data($x/displayName)) eq "{state}"))
 and dateTime(data($r/date))
 eq dateTime("{datestr}")
return $r
'''


def q6_variant(datatype: str, year: int) -> str:
    """Q6 template: joined (name, date, value) rows for one year."""
    return f'''
for $s in collection("/stations")/stationCollection/station
for $r in collection("/sensors")/dataCollection/data
where $s/id eq $r/station
 and $r/dataType eq "{datatype}"
 and year-from-dateTime(dateTime(data($r/date))) eq {year}
return ($s/displayName, $r/date, $r/value)
'''


def q7_variant(country: str, datatype: str, year: int,
               divisor: int = 10) -> str:
    """Q7 template: scaled yearly minimum over one country."""
    return f'''
min(
 for $s in collection("/stations")/stationCollection/station
 for $r in collection("/sensors")/dataCollection/data
 where $s/id eq $r/station
 and (some $x in $s/locationLabels satisfies
 ($x/type eq "CNTRY" and $x/id eq "{country}"))
 and $r/dataType eq "{datatype}"
 and year-from-dateTime(dateTime(data($r/date))) eq {year}
 return $r/value
) div {divisor}
'''


def q8_variant(divisor: int = 10) -> str:
    """Q8 template: scaled average min/max spread (self-join)."""
    return f'''
avg(
 for $r_min in collection("/sensors_min")/dataCollection/data
 for $r_max in collection("/sensors_max")/dataCollection/data
 where $r_min/station eq $r_max/station
 and $r_min/date eq $r_max/date
 and $r_min/dataType eq "TMIN"
 and $r_max/dataType eq "TMAX"
 return $r_max/value - $r_min/value
) div {divisor}
'''


def q9_variant(datatype: str) -> str:
    """Q9 template: per-station keyed aggregation of one type."""
    return f'''
for $r in collection("/sensors")/dataCollection/data
where $r/dataType eq "{datatype}"
group by $st := $r/station
return ($st, count($r), avg($r/value))
'''


def q9d_variant(datatype: str, divisor: int = 10) -> str:
    """Q9 template with post-group arithmetic: the division lands in
    an ASSIGN above the GROUP-BY operator and its literal lifts into
    the parameter vector like any arithmetic literal."""
    return f'''
for $r in collection("/sensors")/dataCollection/data
where $r/dataType eq "{datatype}"
group by $st := $r/station
return ($st, count($r), avg($r/value) div {divisor})
'''


def q10_variant(datatype: str, threshold: float) -> str:
    """Q10 template: group-by with a HAVING-style post-filter (the
    threshold literal lifts into the parameter vector like any
    comparison literal)."""
    return f'''
for $r in collection("/sensors")/dataCollection/data
where $r/dataType eq "{datatype}"
group by $st := $r/station
where sum($r/value) ge {threshold}
return ($st, sum($r/value), max($r/value))
'''


def q11_variant(datatype: str, k: int = 3) -> str:
    """Q11 template: top-k stations by aggregate (ordered group-by).
    The datatype literal lifts into the parameter vector; the limit
    ``k`` is structural (it bounds the compiled output shape) and
    stays part of the plan signature — all serving-path variants keep
    the canonical k so the template compiles once."""
    return f'''
for $r in collection("/sensors")/dataCollection/data
where $r/dataType eq "{datatype}"
group by $st := $r/station
order by sum($r/value) descending
limit {k}
return ($st, count($r), sum($r/value))
'''


def q11c_variant(datatype: str, k: int = 3) -> str:
    """Q11 count-ordered sibling: ascending order on a duplicate-heavy
    aggregate (counts collide constantly), so the grouping-key
    tiebreak decides most of the ranking — the adversarial case for
    cross-engine order agreement."""
    return f'''
for $r in collection("/sensors")/dataCollection/data
where $r/dataType eq "{datatype}"
group by $st := $r/station
order by count($r) ascending
limit {k}
return ($st, count($r), max($r/value))
'''


def q12_variant(datatype: str, year: int) -> str:
    """Q12 template: one admission window's slice of the windowed
    grouped stream — a year-sliced mergeable grouped query (count/
    sum/min/max only), whose per-window partial groups merge
    associatively across batches in serving/window.py."""
    return f'''
for $r in collection("/sensors")/dataCollection/data
where $r/dataType eq "{datatype}"
 and year-from-dateTime(dateTime(data($r/date))) eq {year}
group by $st := $r/station
return ($st, count($r), sum($r/value), min($r/value), max($r/value))
'''


def gq6_variant(datatype: str, year: int) -> str:
    """Q6-style grouped join: per-station-name aggregation over the
    stations-to-sensors hash join."""
    return f'''
for $s in collection("/stations")/stationCollection/station
for $r in collection("/sensors")/dataCollection/data
where $s/id eq $r/station
 and $r/dataType eq "{datatype}"
 and year-from-dateTime(dateTime(data($r/date))) eq {year}
group by $name := $s/displayName
return ($name, count($r), avg($r/value))
'''


def variant_text(name: str, k: int, stations: Sequence[str],
                 years: Sequence[int]) -> str:
    """The ``k``-th deterministic constant-variant of
    queries.ALL[name]. Constants cycle through real data values
    (odometer-style, no RNG) so variants exercise the value paths;
    mixed periods keep most variants textually distinct. Shared by the
    differential harness's grids (``variant_grid``) and the
    multi-tenant traffic generator (``make_tenant_traffic``)."""
    ns, ny = len(stations), len(years)
    st, y = stations[k % ns], years[k % ny]
    dt = DTYPES[k % len(DTYPES)]
    if name == "Q1":
        m, d = DATES[k % len(DATES)]
        return q1_variant(st, y, m, d)
    if name == "Q2":
        return q2_variant(dt, 50.0 + 13.5 * k)
    if name == "Q3":
        return q3_variant(st, ("PRCP", "TMAX", "TMIN")[k % 3],
                          y, 10 + k % 7)
    if name == "Q4":
        return q4_variant(dt, 10 + k % 9)
    if name == "Q5":
        m, d = DATES[k % len(DATES)]
        return q5_variant(STATES[k % len(STATES)],
                          f"{y}-{m:02d}-{d:02d}T00:00:00.000")
    if name == "Q6":
        return q6_variant(dt, y)
    if name == "Q7":
        return q7_variant("FIPS:US", dt, y, 10 + k % 5)
    if name == "Q8":
        return q8_variant(10 + k % 11)
    if name == "Q9":
        return q9_variant(dt)
    if name == "Q10":
        return q10_variant(dt, 25.0 * (k % 8))
    if name == "Q11":
        return q11_variant(dt)
    if name == "Q11c":
        return q11c_variant(dt)
    if name == "Q12":
        return q12_variant(("PRCP", "TMAX", "TMIN")[k % 3], y)
    raise KeyError(name)


def variant_grid(name: str, stations: Sequence[str],
                 years: Sequence[int], n: int) -> list[str]:
    """``n`` deterministic constant-variants of queries.ALL[name] —
    the differential harness's binding grid."""
    return [variant_text(name, k, stations, years) for k in range(n)]


def make_workload(stations: Sequence[str],
                  years: Sequence[int],
                  total: int = 64) -> list[tuple[str, str]]:
    """``total`` (template_name, query_text) pairs cycling through the
    three templates with rotating constants. Deterministic; constants
    are drawn from the given stations/years so variants hit real data
    (an absent constant would still be *correct* — empty result — but
    would not exercise the value paths)."""
    dates = [(12, 25), (7, 4), (1, 15), (3, 10)]
    q2_types = ("AWND", "PRCP", "TMAX", "SNOW")
    q3_types = ("PRCP", "TMAX", "TMIN")
    ns, ny = len(stations), len(years)
    out: list[tuple[str, str]] = []
    # per-template odometer counters: constant tuples enumerate a mixed-
    # radix space, so variants are textually distinct by construction
    # (the exact-signature baseline memoizes repeated query text, which
    # would understate its compile count if the workload repeated)
    k1 = k2 = k3 = 0
    while len(out) < total:
        t = len(out) % 3
        if t == 0:
            m, d = dates[(k1 // (ns * ny)) % len(dates)]
            out.append(("Q1", q1_variant(stations[k1 % ns],
                                         years[(k1 // ns) % ny], m, d)))
            k1 += 1
        elif t == 1:
            # threshold is k-linear: distinct on its own
            out.append(("Q2", q2_variant(q2_types[k2 % len(q2_types)],
                                         100.0 + 7.5 * k2)))
            k2 += 1
        else:
            out.append(("Q3", q3_variant(
                stations[(k3 // ny) % ns], q3_types[(k3 // (ns * ny))
                                                    % len(q3_types)],
                years[k3 % ny], 10 + (k3 % 7))))
            k3 += 1
    return out


def make_groupby_workload(years: Sequence[int], total: int = 64
                          ) -> list[tuple[str, str]]:
    """``total`` (template_name, query_text) pairs cycling through the
    three group-by templates (scan group-by with post-group division
    Q9d, HAVING group-by Q10, Q6-style grouped join GQ6) with rotating
    constants — the keyed-aggregation counterpart of
    ``make_workload``, textually distinct by the same odometer
    construction."""
    ny = len(years)
    out: list[tuple[str, str]] = []
    k9 = k10 = kj = 0
    while len(out) < total:
        t = len(out) % 3
        if t == 0:
            # threshold k-linear: distinct on its own
            out.append(("Q10", q10_variant(
                DTYPES[k10 % len(DTYPES)], 20.0 + 12.5 * k10)))
            k10 += 1
        elif t == 1:
            out.append(("GQ6", gq6_variant(
                DTYPES[kj % len(DTYPES)], years[(kj // len(DTYPES))
                                                % ny])))
            kj += 1
        else:
            out.append(("Q9d", q9d_variant(DTYPES[k9 % len(DTYPES)],
                                           10 + k9 % 9)))
            k9 += 1
    return out


def make_ordered_workload(total: int = 64) -> list[tuple[str, str]]:
    """``total`` (template_name, query_text) pairs cycling through the
    two ordered group-by templates (sum-descending top-k Q11,
    count-ascending top-k Q11c) with rotating datatype constants —
    the "ordered" benchmark suite's workload (top-k pushdown vs
    full-sort-then-slice). NOTE: only the datatype literal is
    liftable (the limit k is structural), so texts repeat after the
    5 DTYPES — fine for this suite, which compares two prepared
    services on identical traffic and never runs an exact-signature
    baseline whose compile count repeats would understate."""
    out: list[tuple[str, str]] = []
    k11 = k11c = 0
    while len(out) < total:
        if len(out) % 2 == 0:
            out.append(("Q11", q11_variant(DTYPES[k11 % len(DTYPES)])))
            k11 += 1
        else:
            out.append(("Q11c",
                        q11c_variant(DTYPES[k11c % len(DTYPES)])))
            k11c += 1
    return out


# ---------------------------------------------------------------------------
# Multi-tenant open-loop traffic (the serving runtime's workload)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic profile: Poisson arrival ``rate`` (mean
    requests per unit of virtual time) and a weighted signature
    ``mix`` over queries.ALL template names — per-tenant skew is what
    makes cross-tenant fairness and cost-based bucketing non-trivial
    to get right."""
    name: str
    rate: float
    mix: tuple[tuple[str, float], ...]


# three archetypes over Q1-Q10: a chatty point-lookup tenant, a
# keyed-aggregation dashboard tenant, and a heavier join/report tenant
DEFAULT_TENANTS = (
    TenantSpec("interactive", 8.0,
               (("Q1", 4.0), ("Q2", 3.0), ("Q5", 1.0))),
    TenantSpec("dashboard", 4.0,
               (("Q3", 2.0), ("Q4", 1.0), ("Q9", 2.0), ("Q10", 1.0))),
    TenantSpec("reporting", 2.0,
               (("Q6", 2.0), ("Q7", 1.0), ("Q8", 1.0))),
)


def make_tenant_traffic(tenants: Sequence[TenantSpec],
                        stations: Sequence[str],
                        years: Sequence[int], *,
                        total: int, seed: int = 0
                        ) -> list[tuple[float, str, str, str]]:
    """Open-loop multi-tenant traffic: ``total`` time-sorted
    ``(arrival, tenant, template, query_text)`` events. Arrivals are
    per-tenant Poisson processes (exponential gaps), templates drawn
    from each tenant's mix, constants from the per-(tenant, template)
    odometer over ``variant_text``. Deterministic per seed — the same
    trace replays with identical admission windows, which is what lets
    benchmarks compare bucketing policies on equal footing."""
    import numpy as np
    rng = np.random.default_rng(seed)
    rate = sum(t.rate for t in tenants)
    # generate past the expected horizon, then cut to exactly `total`
    horizon = 2.0 * total / rate + 1.0
    events: list[tuple[float, str, str, str]] = []
    for ts in tenants:
        names = [n for n, _ in ts.mix]
        w = np.array([w for _, w in ts.mix], dtype=float)
        w /= w.sum()
        ks: dict[str, int] = {}
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / ts.rate))
            if t >= horizon:
                break
            name = names[int(rng.choice(len(names), p=w))]
            k = ks.get(name, 0)
            ks[name] = k + 1
            events.append((t, ts.name, name,
                           variant_text(name, k, stations, years)))
    events.sort(key=lambda e: (e[0], e[1]))
    if len(events) < total:
        raise ValueError(f"traffic horizon too short: {len(events)} "
                         f"< {total} events")
    return events[:total]
