"""The system under test, as the benchmark builds it: gdmix_tpu_torch's
models, made from a configuration file through the program's own parameter
classes. The only module of the benchmark, besides the kinds, that imports
the program."""
from __future__ import annotations

import json
import os

import numpy as np


def _metadata(tmp: str, bag: str, width: int, entity=None) -> str:
    path = os.path.join(tmp, f"{bag}_metadata.json")
    feats = [{"name": bag, "dtype": "float", "shape": [width],
              "isSparse": True},
             {"name": "uid", "dtype": "long", "shape": [],
              "isSparse": False},
             {"name": "offset", "dtype": "float", "shape": [],
              "isSparse": False}]
    if entity:
        feats.append({"name": entity, "dtype": "string", "shape": [],
                      "isSparse": False})
    with open(path, "w") as f:
        json.dump({"features": feats,
                   "labels": [{"name": "response", "dtype": "float",
                               "shape": [], "isSparse": False}]}, f)
    return path


def _solver(cfg: dict) -> dict:
    return dict(l2_reg_weight=cfg["l2_reg_weight"],
                regularize_bias=cfg["regularize_bias"],
                lbfgs_tolerance=cfg["lbfgs_tolerance"],
                lbfgs_pgtol=cfg["lbfgs_pgtol"],
                num_of_lbfgs_iterations=cfg["num_of_lbfgs_iterations"],
                num_of_lbfgs_curvature_pairs=cfg[
                    "num_of_lbfgs_curvature_pairs"],
                sparsity_threshold=cfg["sparsity_threshold"],
                has_intercept=cfg["has_intercept"], dtype=cfg["dtype"])


def base_params(cfg: dict, stage: str):
    from gdmix_tpu_torch.params import Params
    return Params(action="train", stage=stage,
                  model_type=cfg["model_type"], label_column_name="response",
                  uid_column_name="uid",
                  weight_column_name=None,
                  prediction_score_column_name="predictionScore")


def re_model(cfg: dict, coord: dict, tmp: str, device):
    """(RandomEffectLRModel, its Params) of random-effect coordinate
    `coord` of `cfg`; its metadata and feature list written under tmp."""
    from gdmix_tpu_torch.io.feature_list import write_feature_list
    from gdmix_tpu_torch.models.random_effect_lr import RandomEffectLRModel
    from gdmix_tpu_torch.params import REParams
    bag, width = coord["feature_bag"], coord["width"]
    feature_file = os.path.join(tmp, f"{bag}.features")
    write_feature_list([(f"f{i}", "") for i in range(width)], feature_file)
    params = REParams(
        metadata_file=_metadata(tmp, bag, width, coord["partition_entity"]),
        output_model_dir=tmp, feature_bag=bag, feature_file=feature_file,
        partition_entity=coord["partition_entity"], re_mode=cfg["re_mode"],
        newton_phase1_iters=cfg["newton_phase1_iters"], **_solver(cfg))
    bp = base_params(cfg, "random_effect")
    return RandomEffectLRModel(params, bp, device=device), bp


def fe_model(cfg: dict, tmp: str, device):
    """(FixedEffectLRModel, its Params) of `cfg`'s fixed effect."""
    from gdmix_tpu_torch.models.fixed_effect_lr import FixedEffectLRModel
    from gdmix_tpu_torch.params import FixedLRParams
    fe = cfg["fixed_effect"]
    params = FixedLRParams(
        metadata_file=_metadata(tmp, fe["feature_bag"], fe["width"]),
        output_model_dir=tmp, feature_bag=fe["feature_bag"],
        grad_mode=fe["grad_mode"], **_solver(cfg))
    bp = base_params(cfg, "fixed_effect")
    return FixedEffectLRModel(params, bp, device=device), bp


def flat_groups(entity_ids, counts, labels, offsets, indices, values, nnz):
    """A FlatGroups partition of the program from the benchmark's
    columns."""
    from gdmix_tpu_torch.data.bucketing import FlatGroups
    n = len(labels)
    cols = {"uid": np.arange(n, dtype=np.int64), "response": labels,
            "offset": offsets}
    return FlatGroups(entity_ids=entity_ids, counts=counts, columns=cols,
                      indices=indices, values=values, rec_nnz=nnz)


def dense_models(table, num_entities: int, width: int) -> np.ndarray:
    """A random-effect ModelTable as [E, 1 + width] (intercept first; a
    coefficient the table leaves out is 0), rows by integer entity id."""
    out = np.zeros((num_entities, 1 + width))
    if not hasattr(table, "ids"):       # a plain {id: SparseModel}
        from gdmix_tpu_torch.io.model_table import ModelTable
        if not len(table):
            return out
        table = ModelTable.from_models(table, True)
    rows = np.asarray(table.ids).astype(np.int64)
    lens = np.diff(table.offs)
    out[np.repeat(rows, lens), 1 + np.asarray(table.coef_ids, np.int64)] = \
        table.coef_vals
    if table.icpt is not None:
        out[rows, 0] = table.icpt
    return out


def kernel_launches() -> dict:
    from gdmix_tpu_torch.gdmix import kernel_launches as kl
    return kl()


def sparse_batch(wb):
    """The program's SparseBatch over the benchmark's device batch (the
    same tensors, no copy)."""
    from gdmix_tpu_torch.ops.logistic import SparseBatch
    return SparseBatch(indices=wb.indices, values=wb.values,
                       offsets=wb.offsets, labels=wb.labels,
                       weights=wb.weights)

