"""The benchmark's general code: a cell's run (cell.py), its inputs
(inputs.py), the one traffic generator (traffic.py), the comparison that
decides ``correct`` (check.py) and the trace reduction (trace.py)."""
