"""The seeded traffic: a mix is a data file, `traffic/<mix>.json`, whose
`generator` names the module under `traffic/` that makes its requests from
(seed, index) and the file's parameters, the same seed giving the same
requests. A new mix is a new data file, and where it needs requests of a
new kind, one new generator module beside it (a class `Traffic(params,
config, seed, device)`).
"""

from __future__ import annotations

import importlib
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def np_seed(*parts: int) -> int:
    return int(np.random.SeedSequence([int(p) for p in parts])
               .generate_state(1)[0])


def load(name: str) -> dict:
    with open(os.path.join(HERE, f"{name}.json")) as f:
        return json.load(f)


def make(name: str, config: dict, seed: int, device):
    """The requests of mix `name` for one run."""
    params = load(name)
    mod = importlib.import_module(f"traffic.{params['generator']}")
    return mod.Traffic(params, config, seed, device)
