"""Warm restart: checkpoint/restore of a session's optimization state.

The expensive part of IOLM-DB is not serving but the per-(qsig, dsig)
instance optimization (calibration + recipe search) and the cascade
threshold fits.  ``save_warm_state`` persists the three pieces that make
a restart warm:

  1. the **ModelCache**: every compressed model's params (one
     self-validating checkpoint per model under ``models/m<i>/``, through
     ``training/checkpoint.py``), its ``ModelConfig`` and its ``Recipe``;
  2. the **cascade_cache**: fitted acceptance thresholds per
     (qsig, dsig, budget), as JSON (``inf`` thresholds round-trip
     through Python json's ``Infinity`` literal);
  3. the **pool-residency manifest**: which model versions were
     engine-resident at save time, so a restart rebuilds the same working
     set eagerly instead of on first request.

The top-level ``service_state.json`` is written last with
``atomic_write_json``, so a crash mid-save leaves the previous state
readable.  ``restore_warm_state`` rebuilds the caches in a fresh process
(array state through ``restore_tree``, onto the session's device) and
pre-admits the previously resident engines.  A restored session answers
a previously seen (qsig, dsig) query with ``recalibrations == 0`` and
``cascade_fits == 0``.

The reference's ``repro/service/checkpoint.py`` in the same format: the
port's ``ModelConfig``, ``Recipe`` and ``CascadeCalibration`` have the
reference's fields, so either package restores the other's warm state.
The pre-admission is best effort for the pool's refusals only
(``PoolBudgetError``: a smaller budget on the restarted host keeps a
smaller working set); any other error, a ``KernelError`` included,
propagates.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.core.calibrate import CascadeCalibration
from repro_torch.core.pipeline import Recipe
from repro_torch.olap.query import IOLMSession, OptimizedModel
from repro_torch.serving.scheduler import PoolBudgetError
from repro_torch.training import checkpoint as CKPT

MANIFEST = "service_state.json"


def save_warm_state(session: IOLMSession, ckpt_dir: str) -> str:
    """Persist model cache + cascade thresholds + pool residency."""
    os.makedirs(ckpt_dir, exist_ok=True)
    models = []
    for i, ((qsig, dsig), m) in enumerate(session.model_cache._d.items()):
        entry: Dict[str, Any] = {
            "qsig": qsig, "dsig": dsig, "version": m.version,
            "recipe": dataclasses.asdict(m.recipe),
            # identity picks (nothing survived the search) carry the
            # session's own base params — never re-serialized
            "identity": m.params is session.params,
        }
        if not entry["identity"]:
            mdir = os.path.join("models", f"m{i}")
            CKPT.save(os.path.join(ckpt_dir, mdir), 0, m.params,
                      extra={"cfg": dataclasses.asdict(m.cfg)}, keep=1)
            entry["dir"] = mdir
        models.append(entry)
    cascades = [{"qsig": q, "dsig": d, "budget": b, "cal": cal.to_dict()}
                for (q, d, b), cal in session.cascade_cache.items()]
    residency = (session.pool.resident_versions
                 if session.pool is not None else [])
    CKPT.atomic_write_json(
        os.path.join(ckpt_dir, MANIFEST),
        {"version": 1, "models": models, "cascades": cascades,
         "residency": residency})
    return ckpt_dir


def _recipe_from_dict(d: Dict[str, Any]) -> Recipe:
    d = dict(d)
    d["nm"] = tuple(d.get("nm", (0, 0)))
    return Recipe(**d)


def restore_warm_state(session: IOLMSession, ckpt_dir: str, *,
                       prewarm: bool = True) -> Dict[str, Any]:
    """Load warm state into ``session`` (its models onto the session's
    device); returns the manifest.  ``prewarm=True`` re-admits engines
    for the model versions that were pool-resident at save time."""
    with open(os.path.join(ckpt_dir, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("version") != 1:
        raise ValueError(
            f"unsupported warm-state version {manifest.get('version')!r}")
    by_version: Dict[str, OptimizedModel] = {}
    for entry in manifest["models"]:
        recipe = _recipe_from_dict(entry["recipe"])
        if entry["identity"]:
            m = OptimizedModel(session.params, session.cfg, None, recipe,
                               entry["version"])
        else:
            params, _, extra = CKPT.restore_tree(
                os.path.join(ckpt_dir, entry["dir"]), device=session.device)
            m = OptimizedModel(params, ModelConfig(**extra["cfg"]), None, recipe,
                               entry["version"])
        session.model_cache.put(entry["qsig"], entry["dsig"], m)
        by_version[m.version] = m
    for c in manifest["cascades"]:
        session.cascade_cache[(c["qsig"], c["dsig"], float(c["budget"]))] = \
            CascadeCalibration.from_dict(c["cal"])
    if prewarm and session.pool is not None:
        for version in manifest["residency"]:
            try:
                if version == "base":
                    session.pool.engine_for("base", optimize=False)
                elif version in by_version:
                    session.pool.admit(by_version[version])
            except PoolBudgetError:
                # the restarted host's budget or devices hold fewer
                # engines: a smaller prewarmed set, nothing more
                session.log.append(f"[warm] could not pre-admit {version}")
    session.log.append(
        f"[warm] restored {len(manifest['models'])} models, "
        f"{len(manifest['cascades'])} cascade fits from {ckpt_dir}")
    return manifest


__all__ = ["MANIFEST", "restore_warm_state", "save_warm_state"]
