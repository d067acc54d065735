"""Port parity: ``train`` of every objective on the wave grower (7,000
rows, 31 leaves: B1 roots and B2 waves on the card, their plain versions
here), on the CPU, against the JAX package, under PARITY.md's general-data
regime — the check of ``test_torch_objectives_train.py`` (which runs the
strict grower), in a file of its own so that each file stays short."""

import pytest
import torch

from test_torch_objectives_train import OBJECTIVES, check_train_parity


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_train_matches_reference_waves(objective):
    check_train_parity(objective, "waves")
