"""The sweep helpers' stable import path (the reference's
``lightgbm_tpu/utils/sweep.py``): everything re-exports from
:mod:`lightgbm_tpu_torch.sweep`.

* :func:`expand_grid`, :class:`SweepLedger`, ``RESULT_COLUMNS``,
  ``SENTINEL`` -> :mod:`lightgbm_tpu_torch.sweep.ledger`
* :func:`run_grid_search` -> :mod:`lightgbm_tpu_torch.sweep.service`
"""

from __future__ import annotations

from ..sweep.ledger import (RESULT_COLUMNS, SENTINEL, SweepLedger,
                            expand_grid)
from ..sweep.service import run_grid_search

__all__ = ["RESULT_COLUMNS", "SENTINEL", "SweepLedger", "expand_grid",
           "run_grid_search"]
