"""One reader a metric: ``metrics/<name>.py`` holds ``read(run)``, which
takes the run's data (``session.run``'s: the cell, the spans, the
window's presents, the peak, the set-up seconds, the profile of a traced
run, the programs' pools, the profiled frames' rays) and returns the
metric's value, or None where it finds nothing to read (the harness then
leaves the metric out of the line).  A metric split by the cells that
report it, ``<name>.<part>`` (``walk_ms.orbit``), is read by
``metrics/<name>.py``."""

import importlib


def reader(name: str):
    """The module that reads the metric ``name``."""
    return importlib.import_module(
        f"benchmark.metrics.{name.split('.')[0]}")


def read(name: str, run):
    return reader(name).read(run)
