"""On the card: the check's two readings at a cell's own size, as
rollbench/control.py takes them (the program's reading sound, the
control's not). Skips without a card."""

import json

import pytest

from rollbench import control


@pytest.mark.cuda
def test_tx_prove_control_on_the_card(capsys):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert control.main(["--workload", "tx_b2_d6.prove", "--seeds",
                         "4294967311", "--seconds", "3"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not any(summary["program_highest"].values())
    assert summary["control_lowest"]["proofs_wrong"] > 0
