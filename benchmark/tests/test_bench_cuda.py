"""On the card: one toy run of each cell through the command's whole
path, the look for a card included."""
import io
import json

import pytest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["sage-reddit-train",
                                      "gatv2-reddit-infer"])
def test_toy_cell_on_card(card, tiny_root, workload):
    import run

    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", workload, "--seed", "2147483659",
                   "--seconds", "1", "--trace", "1"], root=tiny_root,
                  out=out, log=err)
    assert rc == 0, err.getvalue()[-4000:]
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
