"""Dataset onboarding verification. Port of ``sparkfm_tpu/data/verify.py``.

``python -m sparkfm_tpu_torch verify-data PATH`` proves that a mounted
file is the real public dataset: structural format checks plus the
published row counts and cardinalities, and prints the command that
reproduces its BASELINE config's quality gate on it.

Expected facts are public dataset statistics:

  ml-100k  u.data          100,000 rows, TAB user\\tit\\trating\\tts,
                           943 users, 1682 items, ratings 1..5
  ml-1m    ratings.dat   1,000,209 rows, ``::``-separated, 6040 users
  ml-25m   ratings.csv  25,000,095 rows + header, CSV, 162,541 users,
                           59,047 distinct movies
  criteo   train.txt    45,840,617 rows, TAB, label + 13 int + 26 cat
  avazu    train(.csv)  40,428,967 rows + header, CSV, 24 columns
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Expectation:
    name: str
    filename_hints: Tuple[str, ...]
    rows: int                       # data rows (excl. header)
    has_header: bool
    sep: str
    n_fields: int
    check_row: Callable             # fields -> error string | None
    repro: str                      # quality-gate reproduction command


def _ml_tab_row(f: List[str]) -> Optional[str]:
    if not (f[0].isdigit() and f[1].isdigit()):
        return "user/item not integer"
    r = float(f[2])
    if not 0.5 <= r <= 5:
        return f"rating {r} outside [0.5, 5]"
    return None


def _criteo_row(f: List[str]) -> Optional[str]:
    if f[0] not in ("0", "1"):
        return f"label {f[0]!r} not 0/1"
    for c in f[1:14]:
        if c and not c.lstrip("-").isdigit():
            return f"integer feature {c!r} not an int"
    for c in f[14:]:
        if c and not all(ch in "0123456789abcdef" for ch in c):
            return f"categorical {c!r} not hex"
    return None


def _avazu_row(f: List[str]) -> Optional[str]:
    if f[1] not in ("0", "1"):
        return f"click {f[1]!r} not 0/1"
    return None


PROG = "python -m sparkfm_tpu_torch"
EXPECTATIONS: Dict[str, Expectation] = {
    "ml-100k": Expectation(
        "ml-100k", ("u.data",), 100_000, False, "\t", 4, _ml_tab_row,
        PROG + " train "
        "--movielens {path} --factors 8 --solver sgd "
        "--iters 20  # gate: test RMSE in the 0.91-0.95 band "
        "(tests/test_real_data.py full-scale band)"),
    "ml-1m": Expectation(
        "ml-1m", ("ratings.dat",), 1_000_209, False, "::", 4, _ml_tab_row,
        PROG + " train "
        "--movielens {path} --factors 8 --solver als "
        "--iters 15 --reg-v 0.5  # gate: test RMSE ~0.85-0.87 "
        "(libFM literature band, BASELINE.md)"),
    "ml-25m": Expectation(
        "ml-25m", ("ratings.csv",), 25_000_095, True, ",", 4,
        lambda f: (None if f[0].isdigit() and f[1].isdigit()
                   and 0.5 <= float(f[2]) <= 5 else "bad row"),
        PROG + " train "
        "--movielens {path} --factors 32 --solver als "
        "--iters 10 --reg-v 1.0  # BASELINE config 2"),
    "criteo": Expectation(
        "criteo", ("train.txt",), 45_840_617, False, "\t", 40,
        _criteo_row,
        PROG + " train "
        "--criteo {path} --factors 32 "
        "--task classification --num-features $((1<<24))  # BASELINE "
        "config 3; gate: AUC ~0.78-0.80 (Kaggle logistic-FM band)"),
    "avazu": Expectation(
        "avazu", ("train", "train.csv"), 40_428_967, True, ",", 24,
        _avazu_row,
        PROG + " train "
        "--avazu {path} --factors 8 --fields 22 "
        "--task classification  # BASELINE config 4"),
}


def detect(path: str) -> Optional[str]:
    base = os.path.basename(path)
    for name, ex in EXPECTATIONS.items():
        if base in ex.filename_hints:
            return name
    return None


def verify(path: str, dataset: Optional[str] = None,
           quick: bool = False,
           expected_rows: Optional[int] = None) -> dict:
    """Verify a mounted dataset file. Returns a report dict; key "ok"
    is True only if the format checks AND the row count both pass.

    quick=True checks the first 100K rows' format and skips the full
    row count (useful as a fast preflight on 40M-row files; the full
    count is the actual onboarding gate).
    """
    name = dataset or detect(path)
    if name is None or name not in EXPECTATIONS:
        raise ValueError(
            f"cannot identify dataset for {path!r}; pass dataset= one of "
            f"{sorted(EXPECTATIONS)}")
    ex = EXPECTATIONS[name]
    want_rows = expected_rows if expected_rows is not None else ex.rows

    report = {"dataset": name, "path": path, "ok": True, "errors": [],
              "repro": ex.repro.format(path=path)}
    n = 0
    bad: List[str] = []
    users = set()
    items = set()
    aborted = False
    sample_cap = 100_000
    with open(path, "r", errors="replace") as fh:
        if ex.has_header:
            fh.readline()
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            n += 1
            if n <= sample_cap:
                f = line.split(ex.sep)
                if len(f) != ex.n_fields:
                    bad.append(f"row {n}: {len(f)} fields != "
                               f"{ex.n_fields}")
                else:
                    try:
                        err = ex.check_row(f)
                    except (ValueError, IndexError) as e:
                        err = f"unparseable: {e}"
                    if err:
                        bad.append(f"row {n}: {err}")
                    elif name.startswith("ml"):
                        users.add(f[0])
                        items.add(f[1])
                if len(bad) > 5:
                    aborted = True    # partial count: skip the row-count
                    break             # comparison below (ADVICE r4)
            elif quick:
                n = -1
                break
    if bad:
        report["ok"] = False
        report["errors"] = bad[:5]
    if aborted:
        # the scan stopped early on format errors; n is a lower bound,
        # not the file's row count — comparing it to the published total
        # would misreport the file as truncated
        report["rows"] = f">= {n} (scan aborted after >5 format errors)"
    elif n >= 0:
        report["rows"] = n
        if n != want_rows:
            report["ok"] = False
            report["errors"].append(
                f"row count {n:,} != published {want_rows:,}")
    else:
        report["rows"] = (f">= {sample_cap} (quick mode; full count "
                          "skipped)")
    if users:
        report["sampled_users"] = len(users)
        report["sampled_items"] = len(items)
    return report
