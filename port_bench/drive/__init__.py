"""The drivers that a traffic file's ``method`` names: ``drive/<method>.py``
holds the method's ``Driver``, which builds the program's objects from
the cell's data files and drives them."""

import importlib


def driver_class(method: str):
    """The ``Driver`` of ``drive/<method>.py``."""
    if not method.isidentifier():
        raise KeyError(f"no driver for method {method!r}")
    return importlib.import_module(f"port_bench.drive.{method}").Driver
