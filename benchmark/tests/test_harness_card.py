"""The cells on the card, each with a window just long enough for what it
checks (run there: ``python -m pytest -m cuda benchmark/tests``)."""

from __future__ import annotations

import pytest

CELLS = ["s3dis_seg.serve_scans_200k", "s3dis_seg.train_blocks",
         "modelnet40_cls.train", "s3dis_seg.serve_rooms_1m"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(card, workload):
    from benchmark import run

    out = run.execute(workload, 2 ** 31 + 77, 0.0, True, card)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
    assert all(v["value"] == v["value"] for v in out["metrics"].values())
