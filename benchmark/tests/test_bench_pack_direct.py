"""The ``pack.direct_share`` reader on made-up views: None where the program
recorded no ``pack.direct``, else the share of direct packs in %."""

from __future__ import annotations

import pytest

from benchmark import harness


def _view(totals: dict, counts: dict) -> dict:
    return dict(timer=dict(totals=totals, counts=counts))


def test_pack_direct_reader():
    direct = harness.load_reader("pack.direct_share")
    assert direct.read(_view({}, {})) is None
    assert direct.read(_view({"pack": 0.004}, {"pack": 4})) is None
    v = _view({"pack": 0.004, "pack.direct": 3.0},
              {"pack": 4, "pack.direct": 4})
    assert direct.read(v) == pytest.approx(75.0)
    assert direct.read(_view({"pack.direct": 0.0},
                             {"pack.direct": 4})) == 0.0
