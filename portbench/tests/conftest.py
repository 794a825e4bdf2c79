"""Fixtures of the benchmark's tests: the cells at a few thousand rows on
the CPU, and the card for the tests marked ``cuda``."""

import json
import os
import shutil

import pytest

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the sizes the CPU tests run the cells at: every other key is the real
# configuration's or mix's
TINY_CONFIG = {
    "headline_1m_x_10k": {"jobs": 4096, "nodes": 256, "warm_windows": 1,
                          "trace_windows": 3},
}
TINY_TRAFFIC = {"every_steady": {"sla_bucket": [128, 128]},
                "every_common": {"sla_bucket": [16, 256]}}


def make_tiny(dest: str) -> str:
    """A copy of the package's configurations, mixes and readers at the
    test sizes under ``dest``; returns it (the harness's ``pkg``)."""
    for sub, tiny in (("configs", TINY_CONFIG), ("traffic", TINY_TRAFFIC)):
        os.makedirs(os.path.join(dest, sub), exist_ok=True)
        for fn in os.listdir(os.path.join(PKG, sub)):
            with open(os.path.join(PKG, sub, fn)) as f:
                doc = json.load(f)
            doc.update(tiny.get(fn[:-len(".json")], {}))
            with open(os.path.join(dest, sub, fn), "w") as f:
                json.dump(doc, f)
    shutil.copytree(os.path.join(PKG, "metrics"), os.path.join(dest, "metrics"))
    return dest


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return make_tiny(str(tmp_path_factory.mktemp("tiny")))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
