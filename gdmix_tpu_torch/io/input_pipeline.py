"""Host-side input pipelines: TFRecord files → columnar numpy → padded device arrays.

Replaces the reference's tf.data graphs (linkedin/gdmix:gdmix-trainer/src/gdmix/io/
input_data_pipeline.py): `read_per_record` ↔ per_record_input_fn (Example records,
sparse bags as name_indices/name_values pairs), `read_per_entity_grouped` ↔
per_entity_grouped_input_fn (SequenceExample: context = entity id + per-record
scalars, sequence = ragged sparse features).

Because the TPU trainer is full-batch, the pipeline materializes whole columns and
pads the sparse bag to [N, K] COO (K = max nnz, rounded up for lane alignment)
instead of streaming micro-batches. Padding entries carry value 0.0 and are inert
in every downstream op (see ops/logistic.py).
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gdmix_tpu_torch.io import proto, tfrecord
from gdmix_tpu_torch.io.metadata import DatasetMetadata
from gdmix_tpu_torch.io.shard import shard_input_files

logger = logging.getLogger(__name__)

INDICES_SUFFIX = "_indices"
VALUES_SUFFIX = "_values"


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class PerRecordData:
    """Columnar per-record dataset with one (optional) padded sparse feature bag."""
    columns: Dict[str, np.ndarray]           # dense scalar columns, each [N]
    indices: Optional[np.ndarray] = None     # [N, K] int32
    values: Optional[np.ndarray] = None      # [N, K] float
    nnz: Optional[np.ndarray] = None         # [N] true per-record nnz (un-padding)
    num_samples: int = 0

    def column(self, name: Optional[str], default: Optional[float] = None) -> np.ndarray:
        if name is not None and name in self.columns:
            return self.columns[name]
        if default is None:
            raise KeyError(name)
        return np.full(self.num_samples, default, dtype=np.float64)


def _pad_ragged(ragged_idx: List[np.ndarray], ragged_val: List[np.ndarray],
                align: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    n = len(ragged_idx)
    k = max((len(r) for r in ragged_idx), default=1)
    k = max(_round_up(max(k, 1), align), align)
    indices = np.zeros((n, k), dtype=np.int32)
    values = np.zeros((n, k), dtype=np.float64)
    for i, (ri, rv) in enumerate(zip(ragged_idx, ragged_val)):
        m = len(ri)
        if m:
            indices[i, :m] = ri
            values[i, :m] = rv
    return indices, values


def slice_rows(data: PerRecordData, sel: np.ndarray) -> PerRecordData:
    """Row-select a PerRecordData (sample-level sharding, filtering)."""
    return PerRecordData(
        columns={k: v[sel] for k, v in data.columns.items()},
        indices=None if data.indices is None else data.indices[sel],
        values=None if data.values is None else data.values[sel],
        nnz=None if data.nnz is None else data.nnz[sel],
        num_samples=int(len(sel)))


def shard_samples(data: PerRecordData, num_shards: int,
                  shard_index: int) -> PerRecordData:
    """Sample-level sharding: keep every num_shards-th record (offset
    shard_index) — the reference's dataset.shard fallback when there are fewer
    input files than workers (distribution_utils.py:11-47 consumed by
    input_data_pipeline.py:129-220)."""
    if num_shards <= 1:
        return data
    return slice_rows(data, np.arange(shard_index, data.num_samples,
                                      num_shards))


def _read_file_bytes(path: str) -> bytes:
    """Whole file, decompressed to raw TFRecord framing."""
    import gzip
    import zlib
    from gdmix_tpu_torch.io.tfrecord import compression_of
    comp = compression_of(path)
    from gdmix_tpu_torch.io import fs
    with fs.open(path, "rb") as f:
        raw = f.read()
    if comp == "GZIP":
        return gzip.decompress(raw)
    if comp == "ZLIB":
        return zlib.decompress(raw)
    return raw


def read_per_record(input_path, metadata: DatasetMetadata,
                    feature_bag: Optional[str] = None,
                    num_shards: int = 1, shard_index: int = 0,
                    align: int = 8, use_native: bool = True,
                    custom_input_fn: Optional[str] = None) -> PerRecordData:
    """Read a per-record Example dataset into columns + a padded sparse bag.

    All dense scalar features/labels in the metadata become [N] columns; the
    `feature_bag` sparse tensor becomes padded (indices, values). A C++ decoder
    (gdmix_tpu_torch.native) handles the numeric fast path; string columns fall back
    to the pure-Python codec. `custom_input_fn` ("pkg.mod.fn") overrides the
    loader entirely (reference input_data_pipeline.py:211-217).
    """
    if custom_input_fn:
        import importlib
        module_name, fn_name = custom_input_fn.rsplit(".", 1)
        fn = getattr(importlib.import_module(module_name), fn_name)
        return fn(input_path, metadata, feature_bag, num_shards, shard_index)
    files, sample_level = shard_input_files(input_path, num_shards, shard_index)
    tensors = metadata.tensors()
    dense_names = [name for name, t in tensors.items()
                   if not t.is_sparse and t.dtype not in ("bytes", "string")]
    string_names = [name for name, t in tensors.items()
                    if not t.is_sparse and t.dtype in ("bytes", "string")]

    if use_native and not string_names:
        native_out = _read_per_record_native(files, metadata, dense_names,
                                             feature_bag, align)
        if native_out is not None:
            if sample_level:
                native_out = shard_samples(native_out, num_shards, shard_index)
            return native_out

    cols: Dict[str, list] = {name: [] for name in dense_names + string_names}
    ragged_idx: List[np.ndarray] = []
    ragged_val: List[np.ndarray] = []
    idx_key = f"{feature_bag}{INDICES_SUFFIX}" if feature_bag else None
    val_key = f"{feature_bag}{VALUES_SUFFIX}" if feature_bag else None

    n = 0
    for f in files:
        for payload in tfrecord.read_tfrecords(f):
            ex = proto.decode_example(payload)
            for name in dense_names:
                v = ex.get(name, [])
                cols[name].append(v[0] if v else 0)
            for name in string_names:
                v = ex.get(name, [])
                cols[name].append(v[0] if v else b"")
            if feature_bag:
                ragged_idx.append(np.asarray(ex.get(idx_key, []), dtype=np.int64))
                ragged_val.append(np.asarray(ex.get(val_key, []), dtype=np.float64))
            n += 1

    columns: Dict[str, np.ndarray] = {}
    for name in dense_names:
        info = tensors[name]
        columns[name] = np.asarray(cols[name], dtype=info.np_dtype)
    for name in string_names:
        columns[name] = np.asarray(cols[name], dtype=object)

    indices = values = nnz = None
    if feature_bag:
        indices, values = _pad_ragged(ragged_idx, ragged_val, align)
        nnz = np.asarray([len(r) for r in ragged_idx], dtype=np.int32)
    out = PerRecordData(columns=columns, indices=indices, values=values, nnz=nnz,
                        num_samples=n)
    if sample_level:
        out = shard_samples(out, num_shards, shard_index)
    return out


def load_per_record(input_path, metadata: DatasetMetadata,
                    feature_bag: Optional[str] = None,
                    num_shards: int = 1, shard_index: int = 0,
                    data_format: str = "tfrecord",
                    feature_file: Optional[str] = None,
                    custom_input_fn: Optional[str] = None) -> PerRecordData:
    """Format-dispatching per-record loader (tfrecord | avro | custom hook)."""
    if custom_input_fn:
        return read_per_record(input_path, metadata, feature_bag, num_shards,
                               shard_index, custom_input_fn=custom_input_fn)
    if data_format == "avro":
        from gdmix_tpu_torch.io.avro_dataset import read_per_record_avro
        return read_per_record_avro(input_path, metadata, feature_bag,
                                    num_shards, shard_index,
                                    feature_file=feature_file)
    return read_per_record(input_path, metadata, feature_bag, num_shards,
                           shard_index)


def _pad_to_k(a: np.ndarray, k: int, fill=0) -> np.ndarray:
    """Pad a [n, k0] block to width k (no-op when already wide enough)."""
    if a.shape[1] == k:
        return a
    out = np.full((a.shape[0], k), fill, a.dtype)
    out[:, :a.shape[1]] = a
    return out


def load_per_entity_grouped(input_path, metadata: DatasetMetadata,
                            entity_name: str,
                            feature_bag: Optional[str] = None,
                            num_shards: int = 1, shard_index: int = 0,
                            data_format: str = "tfrecord"):
    """Format-dispatching grouped loader (tfrecord SequenceExample | avro)."""
    if data_format == "avro":
        from gdmix_tpu_torch.io.avro_dataset import read_per_entity_grouped_avro
        return read_per_entity_grouped_avro(input_path, metadata, entity_name,
                                            feature_bag, num_shards, shard_index)
    return read_per_entity_grouped(input_path, metadata, entity_name,
                                   feature_bag, num_shards, shard_index)


def load_per_entity_grouped_flat(input_path, metadata: DatasetMetadata,
                                 entity_name: str,
                                 feature_bag: Optional[str] = None,
                                 num_shards: int = 1, shard_index: int = 0,
                                 data_format: str = "tfrecord"):
    """Columnar grouped loader: native SequenceExample decode straight into a
    data/bucketing.FlatGroups (no per-entity objects). Returns None when the
    fast path doesn't apply (non-tfrecord format, native lib missing, string
    context columns, or per-entity column presence gaps) — callers then fall
    back to load_per_entity_grouped."""
    if data_format != "tfrecord":
        return None
    from gdmix_tpu_torch import native
    if not native.available():
        return None
    from gdmix_tpu_torch.data.bucketing import FlatGroups, select_entities
    tensors = metadata.tensors()
    ctx_names = [n for n, t in tensors.items()
                 if n != entity_name and n != feature_bag
                 and not t.is_sparse and t.dtype != "string"]
    if any(t.dtype == "string" for n, t in tensors.items()
           if n != entity_name and not t.is_sparse):
        return None
    int_names = [n for n in ctx_names if tensors[n].dtype in ("int", "long")]
    files, sample_level = shard_input_files(input_path, num_shards, shard_index)
    parts = []
    for f in files:
        out = native.parse_per_entity_grouped(
            _read_file_bytes(f), ctx_names, entity_name, feature_bag,
            int_names=int_names)
        if out is None:
            return None
        _, _, _, present, _, _, _ = out
        if any(not present[n].all() for n in ctx_names):
            return None  # ragged presence → per-entity object path
        parts.append(out)
    if not parts:
        return FlatGroups(entity_ids=np.zeros(0, object),
                          counts=np.zeros(0, np.int64), columns={},
                          indices=None, values=None, rec_nnz=None)
    entity_ids = np.asarray(
        [e for p in parts for e in p[0]], dtype=object)
    counts = np.concatenate([p[1] for p in parts]).astype(np.int64)
    columns = {
        name: np.concatenate([p[2][name] for p in parts]).astype(
            tensors[name].np_dtype, copy=False)
        for name in ctx_names}
    indices = values = rec_nnz = None
    if feature_bag:
        k = max(p[4].shape[1] for p in parts)
        indices = np.concatenate([_pad_to_k(p[4], k) for p in parts])
        values = np.concatenate([_pad_to_k(p[5], k) for p in parts])
        rec_nnz = np.concatenate([p[6] for p in parts])
    fg = FlatGroups(entity_ids=entity_ids, counts=counts, columns=columns,
                    indices=indices, values=values, rec_nnz=rec_nnz)
    if sample_level and num_shards > 1:
        fg = select_entities(
            fg, np.arange(shard_index, len(fg), num_shards))
    return fg


def _native_parts_to_data(parts, metadata: DatasetMetadata, dense_names,
                          feature_bag: Optional[str], align: int
                          ) -> PerRecordData:
    """Assemble native.parse_per_record outputs into one PerRecordData."""
    tensors = metadata.tensors()
    n = sum(len(next(iter(p[0].values()))) if p[0] else
            (len(p[4]) if p[4] is not None else 0) for p in parts)
    columns: Dict[str, np.ndarray] = {}
    for name in dense_names:
        col = np.concatenate([p[0][name] for p in parts]) if parts else \
            np.zeros(0)
        columns[name] = col.astype(tensors[name].np_dtype)
    indices = values = nnz = None
    if feature_bag:
        k = max((p[2].shape[1] for p in parts if p[2] is not None), default=align)
        indices = np.concatenate([_pad_to_k(p[2], k) for p in parts]).astype(np.int32)
        values = np.concatenate([_pad_to_k(p[3], k) for p in parts])
        nnz = np.concatenate([p[4] for p in parts])
    return PerRecordData(columns=columns, indices=indices, values=values,
                         nnz=nnz, num_samples=n)


def _read_per_record_native(files, metadata: DatasetMetadata, dense_names,
                            feature_bag: Optional[str], align: int
                            ) -> Optional[PerRecordData]:
    from gdmix_tpu_torch import native
    if not native.available():
        return None
    tensors = metadata.tensors()
    int_names = [n for n in dense_names if tensors[n].dtype in ("int", "long")]
    parts = []
    for f in files:
        out = native.parse_per_record(_read_file_bytes(f), dense_names,
                                      feature_bag, align, int_names=int_names)
        if out is None:
            return None
        parts.append(out)
    return _native_parts_to_data(parts, metadata, dense_names, feature_bag,
                                 align)


def iter_per_record_chunks(input_path, metadata: DatasetMetadata,
                           feature_bag: Optional[str] = None,
                           num_shards: int = 1, shard_index: int = 0,
                           chunk_rows: int = 1 << 18, align: int = 8,
                           use_native: bool = True):
    """Stream a per-record TFRecord dataset as bounded-host-memory
    PerRecordData chunks of EXACTLY chunk_rows records (only the last chunk
    is short): the out-of-core ingestion mode. The reference streams epochs
    from disk through tf.data on every L-BFGS funcall
    (input_data_pipeline.py:129-220); here the stream moves disk → HBM ONCE
    (FixedEffectLRModel._device_batch_streamed ships each chunk to the mesh
    as it decodes), so a shard larger than host RAM trains, and funcalls
    stay HBM-resident.

    Frames are walked with bounded memory (tfrecord.read_tfrecord_frames,
    gzip/zlib streamed), concatenated per chunk and decoded through the same
    native/python codecs as load_per_record. Sharding matches
    load_per_record: file-level when files ≥ workers, otherwise the
    sample-level fallback keeps every num_shards-th record of the merged
    stream."""
    from gdmix_tpu_torch import native
    files, sample_level = shard_input_files(input_path, num_shards, shard_index)
    tensors = metadata.tensors()
    dense_names = [name for name, t in tensors.items()
                   if not t.is_sparse and t.dtype not in ("bytes", "string")]
    string_names = [name for name, t in tensors.items()
                    if not t.is_sparse and t.dtype in ("bytes", "string")]
    int_names = [n for n in dense_names if tensors[n].dtype in ("int", "long")]
    native_ok = use_native and not string_names and native.available()

    def decode_chunk(frames) -> PerRecordData:
        if native_ok:
            out = native.parse_per_record(b"".join(frames), dense_names,
                                          feature_bag, align,
                                          int_names=int_names)
            if out is not None:
                return _native_parts_to_data([out], metadata, dense_names,
                                             feature_bag, align)
        cols: Dict[str, list] = {n: [] for n in dense_names + string_names}
        ragged_idx: List[np.ndarray] = []
        ragged_val: List[np.ndarray] = []
        idx_key = f"{feature_bag}{INDICES_SUFFIX}" if feature_bag else None
        val_key = f"{feature_bag}{VALUES_SUFFIX}" if feature_bag else None
        for frame in frames:
            ex = proto.decode_example(frame[12:-4])
            for name in dense_names:
                v = ex.get(name, [])
                cols[name].append(v[0] if v else 0)
            for name in string_names:
                v = ex.get(name, [])
                cols[name].append(v[0] if v else b"")
            if feature_bag:
                ragged_idx.append(np.asarray(ex.get(idx_key, []), np.int64))
                ragged_val.append(np.asarray(ex.get(val_key, []), np.float64))
        columns = {n: np.asarray(cols[n], dtype=tensors[n].np_dtype)
                   for n in dense_names}
        columns.update({n: np.asarray(cols[n], dtype=object)
                        for n in string_names})
        indices = values = nnz = None
        if feature_bag:
            indices, values = _pad_ragged(ragged_idx, ragged_val, align)
            nnz = np.asarray([len(r) for r in ragged_idx], dtype=np.int32)
        return PerRecordData(columns=columns, indices=indices, values=values,
                             nnz=nnz, num_samples=len(frames))

    buf: List[bytes] = []
    gidx = 0
    for f in files:
        for frame in tfrecord.read_tfrecord_frames(f):
            keep = not sample_level or gidx % num_shards == shard_index
            gidx += 1
            if not keep:
                continue
            buf.append(frame)
            if len(buf) == chunk_rows:
                yield decode_chunk(buf)
                buf = []
    if buf:
        yield decode_chunk(buf)


def iter_per_entity_grouped_flat_chunks(input_path, metadata: DatasetMetadata,
                                        entity_name: str,
                                        feature_bag: Optional[str] = None,
                                        num_shards: int = 1,
                                        shard_index: int = 0,
                                        chunk_entities: int = 1 << 16):
    """Stream a grouped (SequenceExample) dataset as bounded-host-memory
    FlatGroups chunks of at most chunk_entities ENTITIES — the random-effect
    out-of-core ingestion mode (one frame = one entity, so frame chunking is
    entity-complete by construction and every entity's records stay whole).

    Yields None (and stops) when the native grouped decoder can't take the
    dataset (native lib missing, string context columns, ragged presence) —
    callers fall back to the eager loaders. Sharding matches
    load_per_entity_grouped_flat: file-level when files ≥ workers, else the
    sample-level fallback keeps every num_shards-th ENTITY of the merged
    stream (select_entities parity)."""
    from gdmix_tpu_torch import native
    if not native.available():
        yield None
        return
    tensors = metadata.tensors()
    ctx_names = [n for n, t in tensors.items()
                 if n != entity_name and n != feature_bag
                 and not t.is_sparse and t.dtype != "string"]
    if any(t.dtype == "string" for n, t in tensors.items()
           if n != entity_name and not t.is_sparse):
        yield None
        return
    int_names = [n for n in ctx_names if tensors[n].dtype in ("int", "long")]
    files, sample_level = shard_input_files(input_path, num_shards,
                                            shard_index)
    from gdmix_tpu_torch.data.bucketing import FlatGroups

    def decode(frames) -> Optional[FlatGroups]:
        out = native.parse_per_entity_grouped(
            b"".join(frames), ctx_names, entity_name, feature_bag,
            int_names=int_names)
        if out is None:
            return None
        eids, counts, cols, present, idx, val, nnz = out
        if any(not present[n].all() for n in ctx_names):
            return None
        columns = {n: cols[n].astype(tensors[n].np_dtype, copy=False)
                   for n in ctx_names}
        return FlatGroups(
            entity_ids=np.asarray(list(eids), dtype=object),
            counts=np.asarray(counts, np.int64), columns=columns,
            indices=idx if feature_bag else None,
            values=val if feature_bag else None,
            rec_nnz=nnz if feature_bag else None)

    buf: List[bytes] = []
    gidx = 0
    for f in files:
        for frame in tfrecord.read_tfrecord_frames(f):
            keep = not sample_level or gidx % num_shards == shard_index
            gidx += 1
            if not keep:
                continue
            buf.append(frame)
            if len(buf) == chunk_entities:
                fg = decode(buf)
                yield fg
                if fg is None:
                    return
                buf = []
    if buf:
        yield decode(buf)


@dataclass
class EntityGroup:
    """One entity's records from a grouped dataset.

    Sparse features come in one of two equivalent forms: ragged per-record
    lists (file decode path) or padded [n, K] blocks + per-record nnz (the
    in-memory partitioner's fast path — no per-record python objects).
    """
    entity_id: str
    columns: Dict[str, np.ndarray]          # per-record scalar columns, each [n]
    ragged_indices: List[np.ndarray] = field(default_factory=list)
    ragged_values: List[np.ndarray] = field(default_factory=list)
    padded_indices: Optional[np.ndarray] = None   # [n, K]
    padded_values: Optional[np.ndarray] = None    # [n, K]
    rec_nnz: Optional[np.ndarray] = None          # [n]

    @property
    def sample_count(self) -> int:
        if self.columns:
            return len(next(iter(self.columns.values())))
        if self.rec_nnz is not None:
            return len(self.rec_nnz)
        return len(self.ragged_indices)

    @property
    def has_sparse(self) -> bool:
        return self.padded_indices is not None or bool(self.ragged_indices)

    def iter_ragged(self):
        """Yield (indices, values) per record regardless of storage form."""
        if self.padded_indices is not None:
            for i in range(len(self.rec_nnz)):
                m = int(self.rec_nnz[i])
                yield (self.padded_indices[i][:m].astype(np.int64),
                       self.padded_values[i][:m])
        else:
            yield from zip(self.ragged_indices, self.ragged_values)


def _read_per_entity_grouped_native(files, metadata: DatasetMetadata,
                                    entity_name: str,
                                    feature_bag: Optional[str]
                                    ) -> Optional[List[EntityGroup]]:
    """C++ SequenceExample fast path: whole-buffer columnar decode, entity
    groups built as zero-copy views (padded-block form). Returns None when the
    native lib is unavailable or a file carries context columns outside the
    metadata schema (string extras etc.) — the python codec then decodes them."""
    from gdmix_tpu_torch import native
    if not native.available():
        return None
    tensors = metadata.tensors()
    ctx_names = [n for n, t in tensors.items()
                 if n != entity_name and n != feature_bag
                 and not t.is_sparse and t.dtype != "string"]
    if any(t.dtype == "string" for n, t in tensors.items()
           if n != entity_name and not t.is_sparse):
        return None   # a declared string context column needs the python path
    int_names = [n for n in ctx_names if tensors[n].dtype in ("int", "long")]
    groups: List[EntityGroup] = []
    for f in files:
        out = native.parse_per_entity_grouped(
            _read_file_bytes(f), ctx_names, entity_name, feature_bag,
            int_names=int_names)
        if out is None:
            return None
        entity_ids, counts, ctx, present, indices, values, nnz = out
        starts = np.concatenate([[0], np.cumsum(counts)])
        for e, entity_id in enumerate(entity_ids):
            sl = slice(int(starts[e]), int(starts[e + 1]))
            columns = {name: ctx[name][sl].astype(tensors[name].np_dtype,
                                                  copy=False)
                       for name in ctx_names if present[name][e]}
            g = EntityGroup(entity_id=entity_id, columns=columns)
            if feature_bag:
                g.padded_indices = indices[sl]
                g.padded_values = values[sl]
                g.rec_nnz = nnz[sl]
            groups.append(g)
    return groups


def read_per_entity_grouped(input_path, metadata: DatasetMetadata,
                            entity_name: str,
                            feature_bag: Optional[str] = None,
                            num_shards: int = 1, shard_index: int = 0,
                            use_native: bool = True) -> List[EntityGroup]:
    """Read a grouped SequenceExample dataset: one record per entity.

    Context carries the scalar entity id plus VarLen per-record columns
    (uid/weight/offset/label); the sequence carries the ragged sparse feature bag.
    Mirrors the reference per_entity_grouped_input_fn (input_data_pipeline.py:223-332).
    A C++ decoder (gdmix_tpu_torch.native) handles the schema-complete fast path.
    """
    if entity_name not in metadata.feature_names:
        raise ValueError(f"entity name {entity_name} is not found among the features")
    files, sample_level = shard_input_files(input_path, num_shards, shard_index)
    if use_native:
        groups = _read_per_entity_grouped_native(files, metadata, entity_name,
                                                 feature_bag)
        if groups is not None:
            if sample_level and num_shards > 1:
                groups = groups[shard_index::num_shards]
            return groups
    tensors = metadata.tensors()
    idx_key = f"{feature_bag}{INDICES_SUFFIX}" if feature_bag else None
    val_key = f"{feature_bag}{VALUES_SUFFIX}" if feature_bag else None

    groups: List[EntityGroup] = []
    for f in files:
        for payload in tfrecord.read_tfrecords(f):
            context, sequence = proto.decode_sequence_example(payload)
            raw_id = context.get(entity_name, [b""])[0]
            entity_id = raw_id.decode("utf-8") if isinstance(raw_id, bytes) else str(raw_id)
            columns: Dict[str, np.ndarray] = {}
            for name, valuelist in context.items():
                if name == entity_name:
                    continue
                info = tensors.get(name)
                dtype = info.np_dtype if info is not None else np.float64
                columns[name] = np.asarray(valuelist, dtype=dtype)
            g = EntityGroup(entity_id=entity_id, columns=columns)
            if feature_bag:
                g.ragged_indices = [np.asarray(r, dtype=np.int64)
                                    for r in sequence.get(idx_key, [])]
                g.ragged_values = [np.asarray(r, dtype=np.float64)
                                   for r in sequence.get(val_key, [])]
            groups.append(g)
    if sample_level and num_shards > 1:
        # each TFRecord is one entity's SequenceExample, so record-level
        # sharding shards entities (reference dataset.shard semantics)
        groups = groups[shard_index::num_shards]
    return groups


def _grouped_flat_arrays(groups: Sequence[EntityGroup], feature_bag):
    """Columnar (counts, col_names, col_arrays, sp_idx, sp_val, nnz) from
    uniform EntityGroups, or None when the groups are heterogeneous."""
    keys = tuple(groups[0].columns.keys())
    if any(tuple(g.columns.keys()) != keys for g in groups):
        return None
    # dtype CLASS (int vs float) must agree across all groups — a lone float
    # group would upcast the concatenation and flip the column's wire type
    kinds = {k: groups[0].columns[k].dtype.kind for k in keys}
    if any(kd not in "iuf" for kd in kinds.values()):
        return None
    for g in groups:
        for k in keys:
            kd = g.columns[k].dtype.kind
            if kd not in "iuf" or (kd in "iu") != (kinds[k] in "iu"):
                return None
    counts = np.fromiter((g.sample_count for g in groups), np.int64,
                         len(groups))
    col_arrays = [np.concatenate([np.asarray(g.columns[k]) for g in groups])
                  if counts.sum() else np.zeros(0) for k in keys]
    sp_idx = sp_val = nnz = None
    if feature_bag:
        if all(g.padded_indices is not None for g in groups):
            K = max((g.padded_indices.shape[1] for g in groups), default=1)
            sp_idx = np.concatenate(
                [_pad_to_k(np.asarray(g.padded_indices, np.int64), K)
                 for g in groups])
            sp_val = np.concatenate(
                [_pad_to_k(np.asarray(g.padded_values, np.float64), K)
                 for g in groups])
            nnz = np.concatenate(
                [np.asarray(g.rec_nnz, np.int32) for g in groups])
        else:
            rows_i, rows_v = [], []
            for g in groups:
                for ri, rv in g.iter_ragged():
                    rows_i.append(np.asarray(ri, np.int64))
                    rows_v.append(np.asarray(rv, np.float64))
            nnz = np.fromiter(map(len, rows_i), np.int32, len(rows_i))
            K = max(int(nnz.max()) if len(nnz) else 1, 1)
            sp_idx = np.zeros((len(rows_i), K), np.int64)
            sp_val = np.zeros((len(rows_i), K), np.float64)
            for r, (ri, rv) in enumerate(zip(rows_i, rows_v)):
                sp_idx[r, :len(ri)] = ri
                sp_val[r, :len(rv)] = rv
    return counts, list(keys), col_arrays, sp_idx, sp_val, nnz


def write_per_entity_grouped(output_file: str, groups: Sequence[EntityGroup],
                             entity_name: str, entity_dtype: str,
                             feature_bag: Optional[str]) -> int:
    """Write groups as SequenceExample TFRecords (the DataPartitioner output format)."""
    idx_key = f"{feature_bag}{INDICES_SUFFIX}" if feature_bag else None
    val_key = f"{feature_bag}{VALUES_SUFFIX}" if feature_bag else None

    # Native columnar encoder (byte-identical framing; ~50x the per-record
    # python datum writer — the DataPartitioner output hot path)
    try:
        from gdmix_tpu_torch import native
        flat = _grouped_flat_arrays(groups, feature_bag) if groups else None
        buf = None
        if flat is not None:
            counts, keys, col_arrays, sp_idx, sp_val, nnz = flat
            buf = native.encode_grouped_records(
                [g.entity_id for g in groups],
                entity_dtype in ("bytes", "string"), entity_name, counts,
                keys, col_arrays, idx_key, val_key, sp_idx, sp_val, nnz)
        if buf is not None:
            with tfrecord._open_write(output_file, None) as f:  # honors .gz/.deflate
                f.write(buf)
            return len(groups)
    except Exception:
        logger.debug("native grouped write failed; python fallback",
                     exc_info=True)

    def payloads():
        for g in groups:
            if entity_dtype in ("bytes", "string"):
                ctx = {entity_name: [g.entity_id.encode("utf-8")]}
            else:
                ctx = {entity_name: [int(g.entity_id)]}
            for name, arr in g.columns.items():
                if arr.dtype.kind in "iu":
                    ctx[name] = [int(v) for v in arr]
                else:
                    ctx[name] = [float(v) for v in arr]
            seq = {}
            if feature_bag:
                rows_i, rows_v = [], []
                for ri, rv in g.iter_ragged():
                    rows_i.append([int(v) for v in ri])
                    rows_v.append([float(v) for v in rv])
                seq[idx_key] = rows_i
                seq[val_key] = rows_v
            yield proto.encode_sequence_example(ctx, seq)

    return tfrecord.write_tfrecords(output_file, payloads())


def write_grouped_flat(output_file: str, fg, entity_name: str,
                       entity_dtype: str, feature_bag: Optional[str]) -> int:
    """write_per_entity_grouped for a columnar FlatGroups — native encode with
    zero conversion; falls back through per-entity EntityGroups otherwise."""
    idx_key = f"{feature_bag}{INDICES_SUFFIX}" if feature_bag else None
    val_key = f"{feature_bag}{VALUES_SUFFIX}" if feature_bag else None
    try:
        from gdmix_tpu_torch import native
        # the bag is written iff feature_bag AND data agree; a mismatch
        # (bag requested but no indices, or vice versa) takes the python
        # path so both writers keep emitting identical bytes
        with_bag = feature_bag is not None and fg.indices is not None
        buf = None if (feature_bag is None) != (fg.indices is None) else \
            native.encode_grouped_records(
                list(fg.entity_ids), entity_dtype in ("bytes", "string"),
                entity_name, fg.counts, list(fg.columns.keys()),
                [fg.columns[k] for k in fg.columns],
                idx_key if with_bag else None,
                val_key if with_bag else None,
                fg.indices if with_bag else None,
                fg.values if with_bag else None,
                fg.rec_nnz if with_bag else None)
        if buf is not None:
            with tfrecord._open_write(output_file, None) as f:
                f.write(buf)
            return len(fg)
    except Exception:
        logger.debug("native flat grouped write failed; python fallback",
                     exc_info=True)
    starts = np.cumsum(fg.counts) - fg.counts
    groups = []
    for e in range(len(fg)):
        sl = slice(int(starts[e]), int(starts[e] + fg.counts[e]))
        g = EntityGroup(entity_id=str(fg.entity_ids[e]),
                        columns={k: v[sl] for k, v in fg.columns.items()})
        if fg.indices is not None:
            g.padded_indices = fg.indices[sl]
            g.padded_values = fg.values[sl]
            g.rec_nnz = (fg.rec_nnz[sl] if fg.rec_nnz is not None
                         else np.full(sl.stop - sl.start,
                                      fg.indices.shape[1], np.int32))
        groups.append(g)
    return write_per_entity_grouped(output_file, groups, entity_name,
                                    entity_dtype, feature_bag)


def write_per_record(output_file: str, metadata: DatasetMetadata,
                     columns: Dict[str, np.ndarray],
                     feature_bag: Optional[str] = None,
                     ragged_indices: Optional[List] = None,
                     ragged_values: Optional[List] = None) -> int:
    """Write a per-record Example TFRecord file from columns (tests & data prep)."""
    n = len(next(iter(columns.values())))
    tensors = metadata.tensors()

    # Native columnar encoder fast path (numeric columns only)
    try:
        from gdmix_tpu_torch import native
        names = list(columns.keys())
        numeric = all(
            np.asarray(columns[k]).dtype.kind in "iuf" and
            (tensors.get(k) is None or
             tensors[k].dtype not in ("bytes", "string"))
            for k in names)
        buf = None
        if numeric:
            sp_idx = sp_val = nnz = None
            if feature_bag:
                lens = np.fromiter(map(len, ragged_indices), np.int32, n)
                K = max(int(lens.max()) if n else 1, 1)
                sp_idx = np.zeros((n, K), np.int64)
                sp_val = np.zeros((n, K), np.float64)
                for i in range(n):
                    sp_idx[i, :lens[i]] = np.asarray(ragged_indices[i],
                                                     np.int64)
                    sp_val[i, :lens[i]] = np.asarray(ragged_values[i],
                                                     np.float64)
                nnz = lens
            buf = native.encode_per_record(
                names, [np.asarray(columns[k]) for k in names],
                f"{feature_bag}{INDICES_SUFFIX}" if feature_bag else None,
                f"{feature_bag}{VALUES_SUFFIX}" if feature_bag else None,
                sp_idx, sp_val, nnz, n)
        if buf is not None:
            from gdmix_tpu_torch.io import fs
            fs.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
            with tfrecord._open_write(output_file, None) as f:  # .gz/.deflate
                f.write(buf)
            return n
    except Exception:
        logger.debug("native per-record write failed; python fallback",
                     exc_info=True)

    def payloads():
        for i in range(n):
            feats = {}
            for name, arr in columns.items():
                v = arr[i]
                info = tensors.get(name)
                if info is not None and info.dtype in ("bytes", "string"):
                    feats[name] = [v if isinstance(v, bytes) else str(v).encode()]
                elif np.issubdtype(type(v), np.integer) or isinstance(v, int):
                    feats[name] = [int(v)]
                else:
                    feats[name] = [float(v)]
            if feature_bag:
                feats[f"{feature_bag}{INDICES_SUFFIX}"] = \
                    [int(x) for x in ragged_indices[i]]
                feats[f"{feature_bag}{VALUES_SUFFIX}"] = \
                    [float(x) for x in ragged_values[i]]
            yield proto.encode_example(feats)

    return tfrecord.write_tfrecords(output_file, payloads())
