"""Analysis tools of the port: `check_counters`, the counters gate; and
the dry run's analysis, the counterparts of `repro.analysis`'s: `hlo`
(collective bytes per category from the communicators' records; the port
has no HLO), `hlo_walk` (the per-rank walker of a program's products,
writes, collectives and live bytes), `roofline` (the three-term roofline
on the H100's constants) and `report` (the dry-run and roofline tables
and the observability section).
"""
