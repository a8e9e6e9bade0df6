"""Fixtures of the benchmark's own tests: a tiny copy of the benchmark's
cells for the CPU, and the card check of the card-only tests.

These tests are run from the repository root, apart from the repository's
tests::

    python -m pytest -q portbench/tests

On a machine with a card the tests marked ``cuda`` run a cell for real."""

import json
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with nvcc; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def write_tiny(tmp) -> dict:
    """A benchmark spec whose configurations are cut to CPU sizes (the
    mixes, the limits, entries and readers are the package's own); returns
    the spec, written to ``tmp/BENCHMARK.json``."""
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for sub in ("configs", "traffic"):
        os.makedirs(os.path.join(tmp, "b", sub), exist_ok=True)
    c = json.load(open(os.path.join(ROOT, spec["configs"][0]["file"])))
    c.update(num_buckets=1 << 12, num_examples=2048)
    c["training"]["batch_size"] = 256
    c["assumed"].update(categorical_cardinalities=[50, 300, 7, 1000],
                        integer_cardinalities=[16, 16])
    m = json.load(open(os.path.join(ROOT, spec["configs"][1]["file"])))
    m.update(num_users=300, num_movies=120, num_ratings=5000, num_factors=4)
    m["rating_counts"]["users"].update(floor=5, first=200)
    for entry, conf in zip(spec["configs"], (c, m)):
        entry["file"] = f"b/configs/{entry['name']}.json"
        json.dump(conf, open(os.path.join(tmp, entry["file"]), "w"))
    json.dump(spec, open(os.path.join(tmp, "BENCHMARK.json"), "w"))
    return spec


@pytest.fixture
def tiny(tmp_path):
    """(spec, root, bench_dir) of the tiny benchmark."""
    torch.set_num_threads(1)
    spec = write_tiny(str(tmp_path))
    return spec, str(tmp_path), str(tmp_path / "b")
