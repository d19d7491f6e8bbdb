"""The heap a test module freed, given back to the system when the module
ends.

An xdist worker runs module after module in one process, and glibc keeps
the memory that the full-width models' float64 steps and XLA's compiles
freed: a worker grows to 14-16 GB over a run, and six of them share the
host's memory.  Import `return_heap` into a test module (it is autouse)."""
import ctypes
import gc

import pytest


def trim_heap():
    """Collect, and give the freed heap back to the system now."""
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


@pytest.fixture(scope="module", autouse=True)
def return_heap():
    yield
    trim_heap()
