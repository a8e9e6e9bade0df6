"""Column schema for raw-text vectorization. Port of
``sparkfm_tpu/data/schema.py`` (pure Python, so it is a copy): a
declarative per-column spec of how one field of a delimited text file
becomes a block of sparse features. All learned state (vocabularies,
offsets) lives in a fitted :class:`~sparkfm_tpu_torch.data.vectorizer.
Vectorizer`.

Column kinds:
  * IDENTITY — categorical one-hot with a learned string->index vocabulary.
  * LIST     — multi-hot over a separator-split list; each element gets
    weight 1/len(list) by default, or 1.0 with ``normalize=False``.
  * NUMBER   — one feature with value = transform(cell).
  * TARGET   — the label column.
  * TIME     — NUMBER with the epoch-seconds -> days transform.
  * HASHED   — categorical via the hashing trick into a fixed bucket count.
  * IGNORED  — column present in the file but dropped.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Sequence


class ColumnKind(enum.Enum):
    IDENTITY = "identity"
    LIST = "list"
    NUMBER = "number"
    TARGET = "target"
    HASHED = "hashed"
    IGNORED = "ignored"


# ---------------------------------------------------------------------------
# Value transforms (reference DataTransformer.scala:8-14).

def bypass(s: str) -> float:
    """Parse the cell as a float (reference BypassData)."""
    return float(s)


def timestamp_to_days(s: str) -> float:
    """Epoch seconds -> days (reference TimeStampToDays)."""
    return float(s) / 86400.0


@dataclasses.dataclass(frozen=True)
class Column:
    """Spec for one raw column.

    Attributes:
      kind: how the cell becomes features.
      name: label used in diagnostics and saved vocab files.
      separator: list separator for LIST columns (reference default ",",
        DataNode.scala:77-79). Interpreted literally, not as a regex.
      transform: str -> float for NUMBER/TIME cells and LIST/IDENTITY weights.
      num_buckets: bucket count for HASHED columns.
      normalize: LIST only — weight each element 1/len (reference
        `distribution`) vs. 1.0.
      oov: IDENTITY only — reserve one extra index per column for
        out-of-vocabulary values at transform time. The reference has no OOV
        story (unseen values would throw in its indexer map); a dedicated
        bucket keeps serving total.
    """

    kind: ColumnKind
    name: str = ""
    separator: str = ","
    transform: Callable[[str], float] = bypass
    num_buckets: int = 0
    normalize: bool = True
    oov: bool = True


# Factory helpers mirroring the reference's DataNode companion
# (DataNode.scala:106-125), plus the new Hashed/Ignored kinds.

def Identity(name: str = "", oov: bool = True) -> Column:
    return Column(ColumnKind.IDENTITY, name=name, oov=oov)


def List(name: str = "", separator: str = ",", normalize: bool = True,
         oov: bool = True) -> Column:
    return Column(ColumnKind.LIST, name=name, separator=separator,
                  normalize=normalize, oov=oov)


def Number(name: str = "",
           transform: Callable[[str], float] = bypass) -> Column:
    return Column(ColumnKind.NUMBER, name=name, transform=transform)


def Target(name: str = "",
           transform: Callable[[str], float] = bypass) -> Column:
    return Column(ColumnKind.TARGET, name=name, transform=transform)


def Time(name: str = "") -> Column:
    return Column(ColumnKind.NUMBER, name=name, transform=timestamp_to_days)


def Hashed(num_buckets: int, name: str = "") -> Column:
    if num_buckets <= 0:
        raise ValueError("Hashed column needs num_buckets > 0")
    return Column(ColumnKind.HASHED, name=name, num_buckets=num_buckets)


def Ignored(name: str = "") -> Column:
    return Column(ColumnKind.IGNORED, name=name)


Schema = Sequence[Column]


def target_index(schema: Schema) -> int:
    """Index of the single TARGET column (exactly one required)."""
    idx = [i for i, c in enumerate(schema) if c.kind == ColumnKind.TARGET]
    if len(idx) != 1:
        raise ValueError(
            f"schema needs exactly one Target column, found {len(idx)}")
    return idx[0]


def read_delimited(path: str, separator: str = "::",
                   encoding: str = "utf-8", errors: str = "replace"):
    """Iterate rows of a delimited text file as lists of strings.

    Host-side replacement for the reference's `sc.textFile(...).map(split)`
    ingestion. The separator is literal (the MovieLens
    `::` files), blank lines are skipped.
    """
    with open(path, "r", encoding=encoding, errors=errors) as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if not line:
                continue
            yield line.split(separator)
