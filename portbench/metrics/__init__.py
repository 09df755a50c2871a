"""Per-layer metrics: ``<name>.py`` is the reader of the metric ``name``
of ``BENCHMARK.json``. ``read(run)`` takes ``{'trace', 'counters',
'device_name'}`` (the traced window's summary, the driver's counters, the
card) and returns the value, or None where the run holds nothing to read.
``arith/`` holds the arithmetic they share."""
