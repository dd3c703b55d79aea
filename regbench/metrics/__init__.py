"""One reader per metric, ``<metric>.py`` with ``read(ctx)``: the metric's
value from the run's clocks, spans, counters or profile, or None where the
run has nothing for it to read (the metric is then left out of the line)."""
