"""One reader a metric, ``<name>.py``, found by the metric's name in
BENCHMARK.json. A reader declares ``UNIT``, ``BETTER`` and ``SOURCE``
(and, for a per-layer metric, ``LAYER`` and ``MOVES``), may name the
program's entry points it needs wrapped in the traced window
(``INSTRUMENT``: (module, attribute) pairs), and gives
``read(record) -> float | None``: None when the run holds nothing for it
to read (the metric is then left out of the result line). ``record`` is
`portbench.harness.Record`."""
