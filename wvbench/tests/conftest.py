"""Shared pieces of the benchmark's CPU tests: cells cut to a size the
program's plain PyTorch path decodes in seconds."""

from __future__ import annotations

import copy

import pytest

from wvbench import manifest
from wvbench.run import cache_dirs

TINY_BLOCK = 1024


@pytest.fixture(scope="session", autouse=True)
def _caches():
    cache_dirs()


def tiny(cell_name: str) -> manifest.Cell:
    """The cell with blocks of 1,024 samples, files of 0.3-0.6 s and two
    calls a pass over the pool: the same code, a CPU-sized input."""
    cell = copy.deepcopy(manifest.resolve(cell_name))
    cell.config["block_samples"] = TINY_BLOCK
    if "encode_options" in cell.config:
        cell.config["encode_options"]["block_samples"] = TINY_BLOCK
    t = cell.traffic
    per_call = min(t["files_per_call"], 2)
    t.update(files_per_call=per_call, pool_files=2 * per_call,
             seconds_min=0.3, seconds_max=0.6, warm_calls=1)
    return cell
