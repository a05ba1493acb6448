"""The paper's eight benchmark queries (§5.2), verbatim — plus four
group-by queries on the paper's §6 'planned next step' (keyed
aggregation): Q9/Q10 (plain / HAVING group-by), Q11 (ordered top-k
group-by: order by an aggregate, limit k) and Q12 (the windowed
grouped stream's per-window slice: one admission window's mergeable
partial-group query). Every query class the serving tier supports has
a canonical representative here."""

Q1 = '''
for $r in collection("/sensors")/dataCollection/data
let $datetime := dateTime(data($r/date))
where $r/station eq "GHCND:USW00012836"
 and year-from-dateTime($datetime) ge 2003
 and month-from-dateTime($datetime) eq 12
 and day-from-dateTime($datetime) eq 25
return $r
'''

Q2 = '''
for $r in collection("/sensors")/dataCollection/data
where $r/dataType eq "AWND"
and decimal(data($r/value)) gt 491.744
return $r
'''

Q3 = '''
sum(
 for $r in collection("/sensors")/dataCollection/data
 where $r/station eq "GHCND:USW00014771"
 and $r/dataType eq "PRCP"
 and year-from-dateTime(dateTime(data($r/date))) eq 1999
 return $r/value
) div 10
'''

Q4 = '''
max(
 for $r in collection("/sensors")/dataCollection/data
 where $r/dataType eq "TMAX"
 return $r/value
) div 10
'''

Q5 = '''
for $s in collection("/stations")/stationCollection/station
for $r in collection("/sensors")/dataCollection/data
where $s/id eq $r/station
 and (some $x in $s/locationLabels satisfies (
 $x/type eq "ST" and
 upper-case(data($x/displayName)) eq "WASHINGTON"))
 and dateTime(data($r/date))
 eq dateTime("1976-07-04T00:00:00.000")
return $r
'''

Q6 = '''
for $s in collection("/stations")/stationCollection/station
for $r in collection("/sensors")/dataCollection/data
where $s/id eq $r/station
 and $r/dataType eq "TMAX"
 and year-from-dateTime(dateTime(data($r/date))) eq 2000
return ($s/displayName, $r/date, $r/value)
'''

Q7 = '''
min(
 for $s in collection("/stations")/stationCollection/station
 for $r in collection("/sensors")/dataCollection/data
 where $s/id eq $r/station
 and (some $x in $s/locationLabels satisfies
 ($x/type eq "CNTRY" and $x/id eq "FIPS:US"))
 and $r/dataType eq "TMIN"
 and year-from-dateTime(dateTime(data($r/date))) eq 2001
 return $r/value
) div 10
'''

Q8 = '''
avg(
 for $r_min in collection("/sensors_min")/dataCollection/data
 for $r_max in collection("/sensors_max")/dataCollection/data
 where $r_min/station eq $r_max/station
 and $r_min/date eq $r_max/date
 and $r_min/dataType eq "TMIN"
 and $r_max/dataType eq "TMAX"
 return $r_max/value - $r_min/value
) div 10
'''

Q9 = '''
for $r in collection("/sensors")/dataCollection/data
where $r/dataType eq "TMAX"
group by $st := $r/station
return ($st, count($r), avg($r/value))
'''

Q10 = '''
for $r in collection("/sensors")/dataCollection/data
where $r/dataType eq "PRCP"
group by $st := $r/station
where sum($r/value) ge 100
return ($st, sum($r/value), max($r/value))
'''

Q11 = '''
for $r in collection("/sensors")/dataCollection/data
where $r/dataType eq "TMAX"
group by $st := $r/station
order by sum($r/value) descending
limit 3
return ($st, count($r), sum($r/value))
'''

Q12 = '''
for $r in collection("/sensors")/dataCollection/data
where $r/dataType eq "PRCP"
 and year-from-dateTime(dateTime(data($r/date))) eq 2000
group by $st := $r/station
return ($st, count($r), sum($r/value), min($r/value), max($r/value))
'''

ALL = {"Q1": Q1, "Q2": Q2, "Q3": Q3, "Q4": Q4,
       "Q5": Q5, "Q6": Q6, "Q7": Q7, "Q8": Q8,
       "Q9": Q9, "Q10": Q10, "Q11": Q11, "Q12": Q12}

SCALAR = ("Q3", "Q4", "Q7", "Q8")    # single-number results
JOINS = ("Q5", "Q6", "Q7", "Q8")
GROUPED = ("Q9", "Q10", "Q11", "Q12")   # keyed-aggregation results
                                        # (float aggregate columns)
ORDERED = ("Q11",)                   # order-by-aggregate + limit
WINDOWED = ("Q12",)                  # mergeable windowed-stream slices
                                     # (count/sum/min/max only, no
                                     # HAVING, no post-group wrappers)
