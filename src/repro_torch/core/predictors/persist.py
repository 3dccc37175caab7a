"""Predictor persistence: ``.npz`` arrays + ``.json`` metadata.

The same two-file format as ``repro.core.predictors.persist``:
``<path>.npz`` holds the fitted arrays (a GBT's flattened ``tree_predict``
node arrays and bin edges; ridge's standardisation and weights; the MLP's
``w{i}``/``b{i}`` as ``p_w{i}``/``p_b{i}`` and its standardisation),
``<path>.json`` the constructor hyper-parameters plus fitted scalars.  This
is how a model fitted by the JAX package becomes the port's:
:func:`load_predictor` reads what the reference's ``save_predictor``
writes, and the loaded model predicts as the reference's does (GBTs bit
for bit, since they grow the identical node arrays).  :func:`save_predictor`
writes the same format, which the reference loads back.  Writes go through
a temp file + ``os.replace``, so a reader never observes a half-written
model.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.predictors.gbt import GBTRegressor, MultiTargetGBT
from repro_torch.core.predictors.linear import RidgeRegressor
from repro_torch.core.predictors.mlp import MLPRegressor
from repro_torch.kernels.tree_predict.ref import (TreeArrays, flatten_gbt,
                                                  unflatten_gbt)

FORMAT_VERSION = 1
_CLASSES = {c.__name__: c for c in (RidgeRegressor, MLPRegressor,
                                     GBTRegressor, MultiTargetGBT)}
#: the reference's histogram switch, replaced in the port by
#: ``fit(..., device=)``; dropped when reading a reference bundle
_REFERENCE_ONLY_PARAMS = ("use_kernel",)


def _hyperparams(model) -> dict:
    return {f.name: getattr(model, f.name)
            for f in dataclasses.fields(model)}


def _atomic_write(path: str, write_fn) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-",
                               suffix=os.path.splitext(path)[1])
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _gbt_arrays(model: GBTRegressor, prefix: str = "") -> dict:
    t = flatten_gbt(model)
    return {f"{prefix}feature": t.feature,
            f"{prefix}threshold_bin": t.threshold_bin,
            f"{prefix}left": t.left, f"{prefix}right": t.right,
            f"{prefix}value": t.value, f"{prefix}n_nodes": t.n_nodes,
            f"{prefix}edges": t.edges}


def _gbt_restore(model: GBTRegressor, arrays, base: float,
                 prefix: str = "") -> GBTRegressor:
    t = TreeArrays(arrays[f"{prefix}feature"],
                   arrays[f"{prefix}threshold_bin"],
                   arrays[f"{prefix}left"], arrays[f"{prefix}right"],
                   arrays[f"{prefix}value"], arrays[f"{prefix}n_nodes"],
                   arrays[f"{prefix}edges"], base, model.learning_rate, 0)
    model.edges_ = arrays[f"{prefix}edges"]
    model.base_ = float(base)
    model.trees_ = unflatten_gbt(t)
    return model


def save_predictor(model, path: str) -> Tuple[str, str]:
    """Save a fitted regressor; returns ``(npz_path, json_path)``.
    ``path`` is the extension-less base path."""
    if not isinstance(model, tuple(_CLASSES.values())):
        raise TypeError(
            f"cannot persist {type(model).__name__}: supported families "
            "are RidgeRegressor, MLPRegressor, GBTRegressor, "
            "MultiTargetGBT")
    meta: dict = {"format": FORMAT_VERSION,
                  "type": type(model).__name__,
                  "params": _hyperparams(model)}
    if isinstance(model, RidgeRegressor):
        arrays = {"x_mu": model.x_mu_, "x_sd": model.x_sd_, "w": model.w_}
    elif isinstance(model, MLPRegressor):
        arrays = {f"p_{k}": v.cpu().numpy() for k, v in model.params_.items()}
        meta["n_layers"] = model.n_layers_
        if model.standardize:
            arrays.update(x_mu=model.x_mu_, x_sd=model.x_sd_,
                          y_mu=model.y_mu_, y_sd=model.y_sd_)
    elif isinstance(model, GBTRegressor):
        arrays = _gbt_arrays(model)
        meta["base"] = model.base_
    else:
        arrays = {}
        meta["n_targets"] = len(model.models_)
        meta["base"] = [m.base_ for m in model.models_]
        for i, m in enumerate(model.models_):
            arrays.update(_gbt_arrays(m, prefix=f"m{i}_"))
    npz_path, json_path = f"{path}.npz", f"{path}.json"
    _atomic_write(npz_path, lambda f: np.savez(f, **arrays))
    _atomic_write(json_path,
                  lambda f: f.write(json.dumps(meta, indent=1,
                                               default=float).encode()))
    return npz_path, json_path


def load_predictor(path: str):
    """Load a regressor saved by this module's or the reference's
    ``save_predictor`` (``path`` is the same extension-less base path)."""
    with open(f"{path}.json") as f:
        meta = json.load(f)
    if meta.get("format", 0) > FORMAT_VERSION:
        raise ValueError(f"predictor bundle {path!r} has format "
                         f"{meta['format']} > supported {FORMAT_VERSION}")
    kind = meta["type"]
    if kind not in _CLASSES:
        raise ValueError(f"unknown predictor type {kind!r} in {path}.json")
    params = {k: tuple(v) if isinstance(v, list) else v   # JSON -> tuples
              for k, v in meta["params"].items()
              if k not in _REFERENCE_ONLY_PARAMS}
    model = _CLASSES[kind](**params)
    with np.load(f"{path}.npz") as npz:
        arrays = dict(npz)
    if kind == "RidgeRegressor":
        model.x_mu_, model.x_sd_, model.w_ = (arrays["x_mu"],
                                              arrays["x_sd"], arrays["w"])
        return model
    if kind == "MLPRegressor":
        model.params_ = {k[2:]: torch.as_tensor(v)
                         for k, v in arrays.items() if k.startswith("p_")}
        model.n_layers_ = int(meta["n_layers"])
        if model.standardize:
            model.x_mu_, model.x_sd_ = arrays["x_mu"], arrays["x_sd"]
            model.y_mu_, model.y_sd_ = arrays["y_mu"], arrays["y_sd"]
        return model
    if kind == "GBTRegressor":
        return _gbt_restore(model, arrays, meta["base"])
    model.models_ = []
    for i in range(int(meta["n_targets"])):
        sub = GBTRegressor(
            n_trees=model.n_trees, max_depth=model.max_depth,
            learning_rate=model.learning_rate,
            subsample=model.subsample, n_bins=model.n_bins,
            seed=model.seed + i)
        model.models_.append(_gbt_restore(sub, arrays, meta["base"][i],
                                          prefix=f"m{i}_"))
    return model
