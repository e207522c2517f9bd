"""Scene data from a configuration file and a seed.

A configuration's ``models`` list names a builder of
``scenes/procedural.py`` with its arguments; ``"seed": "run"`` gives the
builder the run's seed (box heights), a number a fixed one. ``matrix`` is
the model's 3x4 matrix (identity by default). The same data goes to the
program and to the plain reference.
"""
from __future__ import annotations

import numpy as np

from .procedural import BUILDERS


def build_models(config: dict, seed: int) -> list:
    """[(prims, matrix (3, 4) f32)] of every model of `config`."""
    models = []
    for spec in config["models"]:
        args = dict(spec.get("args", {}))
        if "seed" in spec:
            args["seed"] = seed if spec["seed"] == "run" else int(spec["seed"])
        prims, matrix = BUILDERS[spec["kind"]](**args)
        if "matrix" in spec:
            matrix = np.asarray(spec["matrix"], np.float32).reshape(3, 4)
        models.append((prims, matrix))
    return models


def triangle_count(models) -> int:
    return sum(len(p["indices"]) for prims, _ in models for p in prims)


def texel_bytes(models) -> int:
    return sum(img.nbytes for prims, _ in models for p in prims
               for img in p["textures"].values())
