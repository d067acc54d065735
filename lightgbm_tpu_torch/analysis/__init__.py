"""graftlint's backend-neutral part — the port of ``lightgbm_tpu/analysis``.

The AST rules that mean something without JAX (:mod:`.rules`: GL008
determinism, GL009 lock discipline, GL011 typed errors; :mod:`.program`:
GL010 fault-site registry drift, GL014 parity-contract anchors), the
engine and the accepted-debt baseline (:mod:`.engine`, :mod:`.baseline`,
``baseline.toml``), and layer 2 (:mod:`.budgets`): launch budgets counted
from the port's own launches, the analytic budget models on the card's
constants, and their anchors.

Front ends: ``python -m lightgbm_tpu_torch lint`` (:mod:`.cli`) and
``tests/test_torch_graftlint.py``.
"""

from .engine import LintReport, run_lint          # noqa: F401
from .rules import RULE_IDS, Finding, analyze_source  # noqa: F401
