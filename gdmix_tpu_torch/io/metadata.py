"""tensor_metadata.json model.

Same JSON dialect as the reference (linkedin/gdmix:gdmix-trainer/src/gdmix/io/
dataset_metadata.py:5-130): {"features": [...], "labels": [...]} where every tensor has
{name, dtype, shape, isSparse}. dtypes are the avro-ish names int/long/float/double/
bytes/string; ints widen to int64 on decode (TFRecord only stores int64/float/bytes).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

SUPPORTED_TYPES = frozenset(["int", "long", "float", "double", "bytes", "string"])

TO_NP_DTYPE = {
    "int": np.int32,
    "long": np.int64,
    "float": np.float32,
    "double": np.float64,
    "bytes": np.object_,
    "string": np.object_,
}

_REQUIRED_FIELDS = frozenset(["name", "dtype", "shape", "isSparse"])


@dataclass(frozen=True)
class TensorInfo:
    name: str
    dtype: str          # one of SUPPORTED_TYPES
    shape: List[int]
    is_sparse: bool = False

    @property
    def np_dtype(self):
        return TO_NP_DTYPE[self.dtype]

    @property
    def wire_dtype(self):
        """dtype as stored in TFRecord: ints widen to int64 (reference map_int)."""
        if self.dtype in ("int", "long"):
            return np.int64
        if self.dtype in ("float",):
            return np.float32
        if self.dtype in ("double",):
            # TFRecord FloatList is f32; doubles are stored as f32 on the wire.
            return np.float32
        return np.object_

    def to_json(self) -> dict:
        return {"name": self.name, "dtype": self.dtype, "shape": list(self.shape),
                "isSparse": self.is_sparse}


def _parse_tensor(entity: dict) -> TensorInfo:
    if not _REQUIRED_FIELDS.issubset(entity.keys()):
        raise ValueError(
            f"Required metadata fields are {sorted(_REQUIRED_FIELDS)}; "
            f"provided fields are {sorted(entity.keys())}")
    name = entity["name"]
    if name is None or not isinstance(name, str):
        raise ValueError("Feature name can not be None and must be str")
    dtype = entity["dtype"]
    if dtype not in SUPPORTED_TYPES:
        raise ValueError(f"dtype {dtype!r} is not supported; "
                         f"supported types are {sorted(SUPPORTED_TYPES)}")
    shape = entity["shape"]
    if shape is None or not isinstance(shape, list):
        raise ValueError("Feature shape can not be None and must be a list")
    return TensorInfo(name=name, dtype=dtype, shape=shape,
                      is_sparse=bool(entity["isSparse"]))


@dataclass
class DatasetMetadata:
    """Parsed tensor_metadata.json."""
    features: List[TensorInfo] = field(default_factory=list)
    labels: List[TensorInfo] = field(default_factory=list)
    number_of_training_samples: Optional[int] = None

    @classmethod
    def from_json(cls, obj: dict) -> "DatasetMetadata":
        if not isinstance(obj.get("features", []), list):
            raise TypeError(f"Features must be a list. Type {type(obj['features'])} detected.")
        if not isinstance(obj.get("labels", []), list):
            raise TypeError(f"Labels must be a list. Type {type(obj['labels'])} detected.")

        def parse(key: str) -> List[TensorInfo]:
            seen: Dict[str, TensorInfo] = {}
            for entity in obj.get(key, []):
                info = _parse_tensor(entity)
                if info.name in seen:
                    raise ValueError(
                        f"Tensor name in your metadata appears more than once: {info.name}")
                seen[info.name] = info
            return list(seen.values())

        feats, labs = parse("features"), parse("labels")
        dup = {f.name for f in feats} & {l.name for l in labs}
        if dup:
            raise ValueError(f"Tensor name in your metadata appears more than once: {dup}")
        return cls(features=feats, labels=labs,
                   number_of_training_samples=obj.get("numberOfTrainingSamples"))

    @classmethod
    def from_file(cls, path: str) -> "DatasetMetadata":
        from gdmix_tpu_torch.io import fs
        with fs.open(path) as f:
            return cls.from_json(json.load(f))

    def to_json(self) -> dict:
        out = {"features": [t.to_json() for t in self.features],
               "labels": [t.to_json() for t in self.labels]}
        if self.number_of_training_samples is not None:
            out["numberOfTrainingSamples"] = self.number_of_training_samples
        return out

    def save(self, path: str) -> None:
        from gdmix_tpu_torch.io import fs
        with fs.open(path, "w") as f:
            json.dump(self.to_json(), f)

    # -- lookups --------------------------------------------------------------
    @property
    def feature_names(self) -> List[str]:
        return [t.name for t in self.features]

    @property
    def label_names(self) -> List[str]:
        return [t.name for t in self.labels]

    def tensors(self) -> Dict[str, TensorInfo]:
        return {t.name: t for t in self.features + self.labels}

    def feature(self, name: str) -> TensorInfo:
        for t in self.features:
            if t.name == name:
                return t
        raise KeyError(name)

    def has_feature(self, name: Optional[str]) -> bool:
        return name is not None and name in self.feature_names

    def has_label(self, name: Optional[str]) -> bool:
        return name is not None and name in self.label_names

    def feature_shape(self, name: str) -> List[int]:
        return self.feature(name).shape

    def num_features(self, feature_bag: Optional[str]) -> int:
        """Feature-bag width; intercept-only models get one dummy padded feature
        (reference fixed_effect_lr_lbfgs_model.py:157-165)."""
        if feature_bag is None:
            return 1
        n = self.feature_shape(feature_bag)[0]
        assert n > 0, "number of features must be > 0"
        return n
