"""The benchmark's general code: a cell's run (cell.py), its inputs
(inputs.py), the one traffic generator (traffic.py), the comparison that
decides ``correct`` (check.py), the trace reduction (trace.py) and the
program's spans in it (spans.py). What one kind of program needs is its
driver's (benchmark/drivers)."""
