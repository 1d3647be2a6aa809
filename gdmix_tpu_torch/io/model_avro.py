"""photon-ml compatible linear-model Avro IO.

Mirrors the reference's model format exactly (schema:
linkedin/gdmix:gdmix-trainer/src/gdmix/models/schemas.py; writer/reader:
linkedin/gdmix:gdmix-trainer/src/gdmix/util/io_utils.py:45-213):

  * record per model: modelId, modelClass, means[NameTermValue], variances, lossFunction
  * the intercept is the "(INTERCEPT)" NameTermValue and is written FIRST
  * coefficients with |value| <= sparsity_threshold are dropped (intercept always kept)
  * on load, the intercept is moved to the END of the dense coefficient vector
    (fixed-effect layout) or kept sparse (random-effect layout)
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from gdmix_tpu_torch.constants import INTERCEPT, LOGISTIC_MODEL_CLASS
from gdmix_tpu_torch.io import avro
from gdmix_tpu_torch.io import fs
from gdmix_tpu_torch.io.feature_list import Feature, get_feature_map, read_feature_list

BAYESIAN_LINEAR_MODEL_SCHEMA = {
    "type": "record",
    "name": "BayesianLinearModelAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "doc": "a generic schema to describe a Bayesian linear model with means and variances",
    "fields": [
        {"name": "modelId", "type": "string"},
        {"name": "modelClass", "type": ["null", "string"], "default": None},
        {"name": "means", "type": {"type": "array", "items": {
            "type": "record", "name": "NameTermValueAvro",
            "doc": "A tuple of name, term and value. Used as feature or model coefficient",
            "fields": [
                {"name": "name", "type": "string"},
                {"name": "term", "type": "string"},
                {"name": "value", "type": "double"},
            ]}}},
        {"name": "variances", "type": ["null", {"type": "array", "items": "NameTermValueAvro"}],
         "default": None},
        {"name": "lossFunction", "type": ["null", "string"], "default": None},
    ],
}


@dataclass
class SparseModel:
    """A single model in sparse (global-index) form — the random-effect layout.

    theta[0] is the intercept when has_intercept; theta[i+intercept] pairs with
    unique_global_indices[i]. Mirrors the reference TrainingResult
    (linkedin/gdmix:gdmix-trainer/src/gdmix/models/custom/scipy/job_consumers.py:18).
    """
    model_id: str
    theta: np.ndarray
    variance: Optional[np.ndarray]
    unique_global_indices: np.ndarray


def gen_one_avro_model(model_id: str, model_class: str,
                       weight_indices, weight_values, bias,
                       feature_list: Optional[Sequence[Feature]],
                       sparsity_threshold: float) -> dict:
    """Build one photon-ml avro record. Same contract as the reference
    io_utils.gen_one_avro_model (values may be arrays or (mean, variance) tuples)."""
    has_bias = bias is not None
    if isinstance(bias, tuple) and len(bias) == 2 and bias[1] is not None:
        has_variance = True
    elif (weight_values is not None and isinstance(weight_values, tuple)
          and len(weight_values) == 2 and weight_values[1] is not None):
        has_variance = True
    else:
        has_variance = False

    record = {"modelId": model_id, "modelClass": model_class, "means": [],
              "lossFunction": "", "variances": None}
    if has_bias:
        bias_mean = bias[0] if has_variance else bias
        record["means"].append({"name": INTERCEPT, "term": "", "value": float(bias_mean)})
    if has_variance:
        record["variances"] = []
        if has_bias:
            record["variances"].append({"name": INTERCEPT, "term": "", "value": float(bias[1])})

    if weight_indices is not None and weight_values is not None:
        if has_variance:
            mean, variance = weight_values
            variance = np.asarray(variance).flatten()
        else:
            mean = weight_values
        mean = np.asarray(mean).flatten()
        for i, (w_i, w_v) in enumerate(zip(np.asarray(weight_indices).flatten(), mean)):
            if abs(w_v) > sparsity_threshold:
                name, term = feature_list[int(w_i)]
                record["means"].append({"name": name, "term": term, "value": float(w_v)})
                if has_variance:
                    record["variances"].append(
                        {"name": name, "term": term, "value": float(variance[i])})
    return record


def _flat_model_columns(list_of_weight_indices, list_of_weight_values, biases,
                        feature_list):
    """Columnar (coef_ids, coef_vals, coef_vars, model_offs, icpt_vals,
    icpt_vars) for the native encoder, or None when the inputs mix
    variance/no-variance models (the per-record writer handles those)."""
    icpt_vals = icpt_vars = None
    if biases is not None:
        tup = [isinstance(b, tuple) and len(b) == 2 and b[1] is not None
               for b in biases]
        if all(tup) and biases:
            icpt_vals = np.asarray([b[0] for b in biases], np.float64)
            icpt_vars = np.asarray([b[1] for b in biases], np.float64)
        elif not any(tup):
            icpt_vals = np.asarray(biases, np.float64)
        else:
            return None
    coef_ids = coef_vals = coef_vars = model_offs = None
    if (list_of_weight_indices is not None and list_of_weight_values is not None
            and feature_list is not None):
        tup = [isinstance(v, tuple) and len(v) == 2 and v[1] is not None
               for v in list_of_weight_values]
        with_var = all(tup) and bool(tup)
        if any(tup) and not with_var:
            return None
        if (biases is not None and biases
                and with_var != (icpt_vars is not None)):
            return None  # per-record writer resolves mixed intercept/weights
        means = [np.asarray(v[0] if with_var else v, np.float64).ravel()
                 for v in list_of_weight_values]
        model_offs = np.zeros(len(means) + 1, np.int64)
        np.cumsum([m.size for m in means], out=model_offs[1:])
        coef_vals = (np.concatenate(means) if means
                     else np.zeros(0, np.float64))
        coef_ids = (np.concatenate(
            [np.asarray(i, np.int64).ravel() for i in list_of_weight_indices])
            if list_of_weight_indices else np.zeros(0, np.int64))
        if coef_ids.size != coef_vals.size:
            return None
        if coef_ids.size and (coef_ids.min() < 0
                              or coef_ids.max() >= len(feature_list)):
            return None
        if with_var:
            coef_vars = (np.concatenate(
                [np.asarray(v[1], np.float64).ravel()
                 for v in list_of_weight_values]) if means
                else np.zeros(0, np.float64))
            if coef_vars.size != coef_vals.size:
                return None
    return coef_ids, coef_vals, coef_vars, model_offs, icpt_vals, icpt_vars


def export_linear_model_to_avro(model_ids: Sequence,
                                list_of_weight_indices,
                                list_of_weight_values,
                                biases,
                                feature_file: Optional[str],
                                output_file: str,
                                model_class: str = LOGISTIC_MODEL_CLASS,
                                sparsity_threshold: float = 1.0e-4) -> int:
    """Export models in photon-ml avro format (reference io_utils.py:163-212)."""
    feature_list = read_feature_list(feature_file) if feature_file else None
    num_models = len(list_of_weight_indices) if biases is None else len(biases)

    fs.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    # Columnar fast path: pre-encoded (name, term) table + native per-block
    # encoder (the per-record datum writer below is ~100x slower at scale).
    try:
        from gdmix_tpu_torch import native
        flat = _flat_model_columns(list_of_weight_indices,
                                   list_of_weight_values, biases, feature_list)
        if flat is not None and len(model_ids) != num_models:
            flat = None
        blocks = None if flat is None else native.encode_model_blocks(
            model_ids, feature_list, *flat, model_class=model_class,
            threshold=sparsity_threshold)
    except Exception:
        blocks = None
    if blocks is not None:
        return avro.write_encoded_blocks(
            output_file, BAYESIAN_LINEAR_MODEL_SCHEMA, blocks)

    def gen_records() -> Iterator[dict]:
        for i in range(num_models):
            current_bias = None if biases is None else biases[i]
            if list_of_weight_indices is None or list_of_weight_values is None \
                    or feature_list is None:
                yield gen_one_avro_model(str(model_ids[i]), model_class, None, None,
                                         current_bias, feature_list, sparsity_threshold)
            else:
                yield gen_one_avro_model(str(model_ids[i]), model_class,
                                         list_of_weight_indices[i], list_of_weight_values[i],
                                         current_bias, feature_list, sparsity_threshold)

    fs.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    return avro.write_records(output_file, BAYESIAN_LINEAR_MODEL_SCHEMA, gen_records())


def export_model_table_to_avro(table, feature_file: Optional[str],
                               output_file: str,
                               model_class: str = LOGISTIC_MODEL_CLASS,
                               sparsity_threshold: float = 1.0e-4) -> int:
    """export_linear_model_to_avro for a columnar ModelTable: the table's flat
    coef columns feed the native block encoder directly — zero per-entity
    python between the solver output and the OCF bytes. Record-identical to
    the per-record writer (same threshold/ordering rules,
    reference io_utils.py:102-212)."""
    feature_list = read_feature_list(feature_file) if feature_file else None
    fs.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    blocks = None
    try:
        from gdmix_tpu_torch import native
        if feature_list is None:
            # intercept-only export ignores weight columns (reference
            # io_utils.py:86-99 dummy-weight convention)
            flat = (None, None, None, None, table.icpt, table.icpt_vars)
            ok = table.icpt is not None
        else:
            flat = (table.coef_ids, table.coef_vals, table.coef_vars,
                    table.offs, table.icpt, table.icpt_vars)
            ok = (len(table.coef_ids) == 0
                  or (table.coef_ids.min() >= 0
                      and table.coef_ids.max() < len(feature_list)))
        if ok:
            blocks = native.encode_model_blocks(
                list(table.ids), feature_list, *flat, model_class=model_class,
                threshold=sparsity_threshold)
    except Exception:
        blocks = None
    if blocks is not None:
        return avro.write_encoded_blocks(
            output_file, BAYESIAN_LINEAR_MODEL_SCHEMA, blocks)

    # fallback: stream rows one at a time through gen_one_avro_model (the one
    # home for record formatting: NTV ordering, threshold, intercept-first) —
    # O(1) python objects per record, matching the per-record writer
    off = 1 if table.has_intercept else 0

    def gen_records() -> Iterator[dict]:
        for row in range(len(table)):
            sm = table.row_model(row)
            bias = None
            if table.has_intercept:
                bias = ((sm.theta[0], sm.variance[0])
                        if sm.variance is not None else sm.theta[0])
            if feature_list is None:
                yield gen_one_avro_model(str(sm.model_id), model_class, None,
                                         None, bias, feature_list,
                                         sparsity_threshold)
            else:
                weights = ((sm.theta[off:], sm.variance[off:])
                           if sm.variance is not None else sm.theta[off:])
                yield gen_one_avro_model(str(sm.model_id), model_class,
                                         sm.unique_global_indices, weights,
                                         bias, feature_list,
                                         sparsity_threshold)

    return avro.write_records(output_file, BAYESIAN_LINEAR_MODEL_SCHEMA,
                              gen_records())


def _table_from_parse(parsed, feature_list, has_intercept: bool):
    """Columnar ModelTable straight from the native parse — whole-array ops
    only. Returns None on anomalies (unknown features, misplaced intercepts,
    mixed variance presence): callers fall back to the per-record path, which
    raises the reference's exact errors."""
    from gdmix_tpu_torch.io.model_table import ModelTable
    model_ids, mean_offs, mean_ids, mean_vals, var_vals, var_present = parsed
    E = len(model_ids)
    if E == 0:
        return ModelTable.empty(has_intercept, with_variance=False)
    n_var = int(np.asarray(var_present, bool).sum())
    if 0 < n_var < E:
        return None
    with_var = n_var == E
    lens = np.diff(mean_offs)
    if has_intercept:
        if (lens < 1).any() or (mean_ids[mean_offs[:-1]] != -1).any():
            return None
        keep = np.ones(len(mean_ids), bool)
        keep[mean_offs[:-1]] = False
        coef_ids = mean_ids[keep]
        coef_vals = mean_vals[keep]
        offs = mean_offs - np.arange(E + 1)
        icpt = mean_vals[mean_offs[:-1]].copy()
        icpt_vars = var_vals[mean_offs[:-1]].copy() if with_var else None
        coef_vars = var_vals[keep] if with_var else None
    else:
        coef_ids, coef_vals = mean_ids.copy(), mean_vals.copy()
        offs, icpt, icpt_vars = mean_offs.copy(), None, None
        coef_vars = var_vals.copy() if with_var else None
    if coef_ids.size and coef_ids.min() < 0:
        return None  # unknown feature / extra intercept
    if feature_list is None:
        if coef_ids.size or with_var:
            # features on an intercept-only load, or intercept-only with
            # variance (whose dict form has len(variance) != len(theta) —
            # not representable columnar): per-record path handles both
            return None
        # dummy feature 0 with weight 0 per model (reference io_utils.py:86-99)
        coef_ids = np.zeros(E, np.int64)
        coef_vals = np.zeros(E, np.float64)
        offs = np.arange(E + 1, dtype=np.int64)
    return ModelTable(ids=np.asarray(model_ids, object), offs=offs,
                      coef_ids=coef_ids, coef_vals=coef_vals, icpt=icpt,
                      coef_vars=coef_vars, icpt_vars=icpt_vars)


def _parse_native(model_file: str, feature_list):
    """Native columnar parse of a model OCF, or None → per-record fallback."""
    try:
        from gdmix_tpu_torch import native
        # the native parser mmaps a real path: copy-through-local for remote
        # schemes (reference io_utils.py:299-334)
        with fs.local_input(model_file) as local:
            return native.parse_model_file(local, feature_list)
    except Exception:
        return None


def load_linear_models_from_avro(model_file: str, feature_file: Optional[str]
                                 ) -> Tuple[np.ndarray, ...]:
    """Load dense fixed-effect-layout models: intercept moved to the END
    (reference io_utils.py:45-83)."""
    feature_list = read_feature_list(feature_file) if feature_file else None
    parsed = _parse_native(model_file, feature_list)
    if parsed is not None:
        model_ids, mean_offs, mean_ids, mean_vals, _, _ = parsed
        nf = len(feature_list) if feature_list is not None else 0
        out = []
        for e in range(len(model_ids)):
            ids = mean_ids[mean_offs[e]:mean_offs[e + 1]]
            vals = mean_vals[mean_offs[e]:mean_offs[e + 1]]
            coef = np.zeros(nf + 1, np.float64)
            known = ids >= 0
            coef[ids[known]] = vals[known]
            icpt = ids == -1
            has_bias = bool(icpt.any())
            if has_bias:
                coef[nf] = vals[icpt][-1]
            out.append(coef[:nf + has_bias])
        return tuple(out)
    feature_map = get_feature_map(feature_file) if feature_file else None

    def one(record) -> np.ndarray:
        num_features = 0 if feature_map is None else len(feature_map)
        coef = np.zeros(num_features + 1, dtype=np.float64)
        has_bias = 0
        for ntv in record["means"]:
            name, term, value = ntv["name"], ntv["term"], np.float64(ntv["value"])
            if name == INTERCEPT and term == "":
                coef[num_features] = value
                has_bias = 1
            elif feature_map is not None:
                idx = feature_map.get((name, term))
                if idx is not None:
                    coef[idx] = value
        return coef[:num_features + has_bias]

    return tuple(one(r) for r in avro.read_records(model_file))


def add_dummy_weight(models: Tuple[np.ndarray, ...]) -> Tuple[np.ndarray, ...]:
    """Prepend a zero dummy weight to intercept-only models (reference io_utils.py:86-99)."""
    def one(model):
        coef = np.zeros(2, dtype=np.float64)
        coef[1] = model[0]
        return coef
    return tuple(one(m) for m in models)


def load_sparse_models_from_avro(model_file: str, feature_file: Optional[str],
                                 has_intercept: bool = True,
                                 as_table: bool = False):
    """Load random-effect-layout models keyed by modelId
    (reference random_effect_lr_lbfgs_model.py:256-309). With as_table=True,
    returns a columnar ModelTable (a Mapping[str, SparseModel]) built with
    zero per-entity python when the native parse applies."""
    feature_list = read_feature_list(feature_file) if feature_file else None
    parsed = _parse_native(model_file, feature_list)
    if parsed is not None and as_table:
        table = _table_from_parse(parsed, feature_list, has_intercept)
        if table is not None:
            return table
    if parsed is not None:
        model_ids, mean_offs, mean_ids, mean_vals, var_vals, var_present = parsed
        ok = True
        out: Dict[str, SparseModel] = {}
        for e in range(len(model_ids)):
            ids = mean_ids[mean_offs[e]:mean_offs[e + 1]]
            vals = mean_vals[mean_offs[e]:mean_offs[e + 1]]
            tail = ids[1:] if has_intercept else ids
            # anomalies (unknown feature, misplaced intercept, features on an
            # intercept-only load) reuse the python path's exact errors
            if ((has_intercept and (ids.size == 0 or ids[0] != -1))
                    or (tail < 0).any()
                    or (feature_list is None and tail.size)):
                ok = False
                break
            variance = (var_vals[mean_offs[e]:mean_offs[e + 1]].copy()
                        if var_present[e] else None)
            theta = vals.copy()
            indices = tail.copy()
            if feature_list is None:
                theta = np.append(theta, 0.0)
                indices = np.array([0], np.int64)
            out[model_ids[e]] = SparseModel(
                model_id=model_ids[e], theta=theta, variance=variance,
                unique_global_indices=indices)
        if ok:
            return out
    feature2global = get_feature_map(feature_file) if feature_file else None
    out: Dict[str, SparseModel] = {}
    for record in avro.read_records(model_file):
        model_id = record["modelId"]
        coefs: List[float] = []
        indices: List[int] = []
        variance: List[float] = []
        for idx, ntv in enumerate(record["means"]):
            coefs.append(np.float64(ntv["value"]))
            if has_intercept and idx == 0:
                assert ntv["name"] == INTERCEPT and ntv["term"] == ""
            else:
                indices.append(feature2global[(ntv["name"], ntv["term"])])
        if record.get("variances"):
            for idx, ntv in enumerate(record["variances"]):
                variance.append(np.float64(ntv["value"]))
                if has_intercept and idx == 0:
                    assert ntv["name"] == INTERCEPT and ntv["term"] == ""
                else:
                    assert indices[idx - (1 if has_intercept else 0)] == \
                        feature2global[(ntv["name"], ntv["term"])]
        if feature2global is None:
            # intercept-only model: pad one dummy feature.
            assert len(indices) == 0
            coefs.append(np.float64(0.0))
            indices.append(0)
        out[model_id] = SparseModel(
            model_id=model_id,
            theta=np.array(coefs, dtype=np.float64),
            variance=np.array(variance, dtype=np.float64) if variance else None,
            unique_global_indices=np.array(indices, dtype=np.int64))
    return out
