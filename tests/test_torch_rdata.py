"""Port parity: the ``.RData`` sweep ledger (``utils/rdata.py``,
``sweep/ledger.py``) against the reference's on the CPU.

* the repo's ``paramGrid_tpu.RData`` (108 rows) reads to equal dicts in both
  packages;
* ``write_rdata`` writes the reference's bytes for the same columns (ints,
  reals, strings, NA), whatever the file name;
* a ledger saved by either package resumes in the other, and the two
  packages' saves of the same rows are byte-identical;
* the port's ledger resumes ``paramGrid_tpu.RData``, skipping its done rows
  and rerunning the ones that carry the -1 sentinel.
"""

import os

import numpy as np
import pytest

from lightgbm_tpu.sweep.ledger import SweepLedger as RLedger
from lightgbm_tpu.utils.rdata import read_rdata as r_read
from lightgbm_tpu.utils.rdata import write_rdata as r_write
from lightgbm_tpu_torch.sweep.ledger import SENTINEL, SweepLedger, expand_grid
from lightgbm_tpu_torch.utils.rdata import read_rdata, write_rdata

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "paramGrid_tpu.RData")
FROZEN_CLOCK = lambda: 0.0  # noqa: E731 — pins saved_at for byte parity


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _fixture_grid():
    df = read_rdata(FIXTURE)["paramGrid"]
    n = len(df["iteration"])
    return df, [{k: df[k][i] for k in df if k not in ("iteration", "score")}
                for i in range(n)]


def test_fixture_reads_equal_in_both_packages():
    got, want = read_rdata(FIXTURE), r_read(FIXTURE)
    assert got == want
    pg = got["paramGrid"]
    assert list(pg) == ["iteration", "score", "learning_rate", "num_leaves",
                        "min_data_in_leaf", "feature_fraction",
                        "bagging_fraction", "bagging_freq", "nthread"]
    assert all(len(v) == 108 for v in pg.values())


@pytest.mark.parametrize("cols", [
    {"iteration": [269, -1, 3], "score": [-0.0095, -1.0, float("nan")],
     "name": ["a", None, "ü"], "flag": [True, False, None]},
    {"iteration": [1.0], "score": [-0.5], "num_leaves": [7.0]},
    {"x": []},
], ids=["mixed", "reals", "empty"])
def test_write_rdata_bytes_equal_reference(tmp_path, cols):
    a, b, c = (str(tmp_path / n) for n in ("p.RData", "r.RData",
                                           "other_name.RData"))
    write_rdata(a, "paramGrid", cols)
    r_write(b, "paramGrid", cols)
    write_rdata(c, "paramGrid", cols)
    assert _bytes(a) == _bytes(b) == _bytes(c)
    assert repr(read_rdata(a)) == repr(r_read(b))      # NaN != NaN


def test_write_read_roundtrip(tmp_path):
    cols = {"iteration": [269, -1], "score": [-0.0095, -1.0],
            "name": ["a", None], "flag": [True, False]}
    p = str(tmp_path / "t.RData")
    write_rdata(p, "paramGrid", cols)
    out = read_rdata(p)["paramGrid"]
    assert out["iteration"] == [269, -1]
    assert out["score"] == [-0.0095, -1.0]
    assert out["name"] == ["a", None]
    assert out["flag"] == [1, 0]          # R logicals read back as ints


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_ledger_resumes_across_packages(tmp_path, writer):
    grid = expand_grid(learning_rate=[0.1, 0.01], num_leaves=[31, 63],
                       nthread=[4])
    first, second = ((SweepLedger, RLedger) if writer == "port"
                     else (RLedger, SweepLedger))
    path = str(tmp_path / "paramGrid.RData")
    led = first(grid, path)
    led.record(0, 100, -0.5)
    led.record(2, 200, -0.25)

    led2 = second(grid, path)
    assert [led2.done(i) for i in range(4)] == [True, False, True, False]
    assert led2.rows[2]["iteration"] == 200
    assert led2.rows[2]["score"] == -0.25
    # both packages finish the sweep to the same bytes
    other = str(tmp_path / "other.RData")
    with open(other, "wb") as f:
        f.write(_bytes(path))
    led3 = first(grid, other)
    for led_x in (led2, led3):
        led_x.record(1, 7, -0.125)
        led_x.record(3, 9, -0.0625)
    assert _bytes(path) == _bytes(other)


@pytest.mark.parametrize("suffix", ["RData", "json"])
def test_ledger_saves_byte_identical_to_reference(tmp_path, suffix):
    grid = expand_grid(learning_rate=[0.3, 0.1], num_leaves=[7, 15])
    a, b = str(tmp_path / f"p.{suffix}"), str(tmp_path / f"r.{suffix}")
    for cls, path in ((SweepLedger, a), (RLedger, b)):
        led = cls(grid, path, clock=FROZEN_CLOCK)
        led.record(1, 12, -0.75)
        led.record(3, 4, -1.5)
    assert _bytes(a) == _bytes(b)


def test_ledger_resumes_fixture_skipping_done_rows(tmp_path):
    df, grid = _fixture_grid()
    led = SweepLedger(grid, FIXTURE, clock=FROZEN_CLOCK)
    assert len(led.rows) == 108
    assert led.pending() == [i for i in range(108)
                             if df["iteration"][i] == SENTINEL]
    assert led.leaderboard() == RLedger(grid, FIXTURE).leaderboard()

    # the fixture with ten rows crashed (-1 sentinels), as R leaves them:
    # the port reruns exactly those, keeps the rest
    crashed = list(range(3, 108, 11))[:10]
    cols = {k: list(v) for k, v in df.items()}
    for i in crashed:
        cols["iteration"][i] = SENTINEL
        cols["score"][i] = SENTINEL
    path = str(tmp_path / "paramGrid.RData")
    r_write(path, "paramGrid", cols)
    led = SweepLedger(grid, path)
    assert led.pending() == crashed
    kept = [i for i in range(108) if i not in crashed]
    assert all(led.rows[i]["iteration"] == df["iteration"][i]
               and led.rows[i]["score"] == df["score"][i] for i in kept)
    np.testing.assert_array_equal(led.to_numpy()[1],
                                  RLedger(grid, path).to_numpy()[1])
