"""Global feature vocabulary: string feature key -> dense column index.

The reference builds a *per-block local* string->index map inside every
reducer (reference: LibLinearDataset.java:83-99,425-447) and keeps the
consensus state keyed by strings. A TPU design wants one global dense index so
that every block's coefficient vector lives in the same dense coordinate
system and the consensus z/u updates are plain vector ops / collectives. The
intercept keeps the reference's semantics: it is appended as the *last* index
(reference: LibLinearDataset.finish, LibLinearDataset.java:592-615 appends the
bias term as feature index n) under the reserved name "(INTERCEPT)"
(LibLinearDataset.java:92), and user features may not collide with it
(LibLinearDataset.java:397-398).
"""

from __future__ import annotations

from typing import Iterable, Iterator, Mapping

from mlease_tpu_torch.io.records import INTERCEPT_NAME


class FeatureVocab:
    """Mutable until frozen; index space is [0, size)."""

    def __init__(self, has_intercept: bool = True):
        self._index: dict[str, int] = {}
        self._names: list[str] = []
        self._frozen = False
        self.has_intercept = has_intercept

    # -- construction -----------------------------------------------------
    def add(self, name: str) -> int:
        idx = self._index.get(name)
        if idx is not None:
            return idx
        if self._frozen:
            raise ValueError(f"vocab is frozen; unknown feature {name!r}")
        if name == INTERCEPT_NAME:
            raise ValueError(f"feature name cannot be {INTERCEPT_NAME}")
        idx = len(self._names)
        self._index[name] = idx
        self._names.append(name)
        return idx

    def add_all(self, names: Iterable[str]) -> None:
        for n in names:
            self.add(n)

    @classmethod
    def from_names(cls, names: Iterable[str],
                   has_intercept: bool = True) -> "FeatureVocab":
        """Frozen vocab from an ordered feature-name list (the intercept
        column is appended last when has_intercept). The public constructor
        for benches/tools that already hold a final name list."""
        v = cls(has_intercept=has_intercept)
        for n in names:
            v.add(n)
        return v.freeze()

    def freeze(self) -> "FeatureVocab":
        """Finalize: when has_intercept, the intercept becomes the last index."""
        if not self._frozen:
            if self.has_intercept:
                idx = len(self._names)
                self._index[INTERCEPT_NAME] = idx
                self._names.append(INTERCEPT_NAME)
            self._frozen = True
        return self

    # -- lookup -----------------------------------------------------------
    @property
    def frozen(self) -> bool:
        return self._frozen

    @property
    def size(self) -> int:
        """Total dense dimension, including the intercept column if present."""
        return len(self._names)

    @property
    def num_features(self) -> int:
        """Number of non-intercept features."""
        return len(self._names) - (1 if self._frozen and self.has_intercept else 0)

    @property
    def intercept_index(self) -> int | None:
        if self._frozen and self.has_intercept:
            return len(self._names) - 1
        return None

    def get(self, name: str, default: int | None = None) -> int | None:
        return self._index.get(name, default)

    def __getitem__(self, name: str) -> int:
        return self._index[name]

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def name(self, index: int) -> str:
        return self._names[index]

    @property
    def names(self) -> list[str]:
        return list(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def __iter__(self) -> Iterator[str]:
        return iter(self._names)

    # -- vector helpers ---------------------------------------------------
    def densify(self, mapping: Mapping[str, float] | None, default: float,
                out=None):
        """Map {feature -> value} onto a dense vector of size `self.size`,
        filling absent features with `default`. Mirrors LibLinear.initSetup
        (reference: LibLinear.java:476-497)."""
        import numpy as np

        if out is None:
            out = np.full(self.size, default, dtype=np.float64)
        else:
            out[:] = default
        if mapping:
            for k, v in mapping.items():
                idx = self._index.get(k)
                if idx is not None:
                    out[idx] = v
        return out

    def to_mapping(self, vec, drop_zeros: bool = False) -> dict[str, float]:
        out = {}
        for i, name in enumerate(self._names):
            v = float(vec[i])
            if drop_zeros and v == 0.0:
                continue
            out[name] = v
        return out

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        import json
        import os

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"has_intercept": self.has_intercept,
                       "frozen": self._frozen,
                       "names": self._names}, f)

    @classmethod
    def load(cls, path: str) -> "FeatureVocab":
        import json

        with open(path) as f:
            data = json.load(f)
        v = cls(has_intercept=data["has_intercept"])
        names = data["names"]
        if data["frozen"] and data["has_intercept"]:
            names = names[:-1]
        for n in names:
            v.add(n)
        if data["frozen"]:
            v.freeze()
        return v


def build_vocab(rows: Iterable[Mapping], has_intercept: bool = True) -> FeatureVocab:
    """One ingest pass over canonical rows -> frozen global vocab."""
    vocab = FeatureVocab(has_intercept=has_intercept)
    for row in rows:
        for key, _v in row["features"]:
            vocab.add(key)
    return vocab.freeze()
