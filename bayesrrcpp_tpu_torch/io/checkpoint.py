"""Checkpoint and resume of a sampler's state and its generator.

Counterpart of ``bayesrrcpp_tpu/io/checkpoint.py``.  The reference's only
resume is BRV2Grstart, which takes the last CSV row and loses the random
stream (src/BRv2Grstart.cpp:55-77; SURVEY.md section 5).  The JAX
package's checkpoint holds the state with its PRNG key; here the key's
place is taken by the ``torch.Generator`` that draws the chain's steps, so
a chain resumed from a checkpoint is bitwise the uninterrupted one.

Format: one ``.npz`` with an array per state field, the generator's
``get_state()`` (uint8) and a JSON manifest naming the state class, its
fields, the iteration and the generator's device type.  A generator of
one device type resumes on that type only (a CPU generator's state is not
a CUDA generator's).  A JAX checkpoint (a ``key`` field and no generator
state) is refused: its threefry key cannot seed a torch generator.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..models.state import HorseshoeState, SpikeSlabState

_STATE_TYPES = {
    "SpikeSlabState": SpikeSlabState,
    "HorseshoeState": HorseshoeState,
}
_GENERATOR = "__generator__"
_MANIFEST = "__manifest__"


def save_checkpoint(path: str, state, generator: torch.Generator) -> None:
    """Write ``state`` (one chain or chain-batched) and ``generator``'s
    state to ``path`` (.npz).  Call it where the generator has drawn
    exactly the steps that made ``state``: after ``run`` returns, or in
    ``run``'s ``on_chunk``."""
    cls = type(state).__name__
    if cls not in _STATE_TYPES:
        raise TypeError(f"unknown state type {cls}")
    fields = [f.name for f in dataclasses.fields(state)
              if f.name != "iteration"]
    arrays = {f: getattr(state, f).detach().cpu().numpy() for f in fields}
    arrays[_GENERATOR] = generator.get_state().numpy()
    arrays[_MANIFEST] = np.frombuffer(json.dumps({
        "state_class": cls, "fields": fields,
        "iteration": int(state.iteration),
        "generator_device": generator.device.type,
        "format_version": 1}).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_checkpoint(path: str, device=None):
    """(state, generator) of a checkpoint written by ``save_checkpoint``,
    on ``device`` (default: a device of the generator's type, "cuda" or
    "cpu").  Stepping the state with the generator continues the original
    chain bit for bit."""
    with np.load(path) as z:
        if _MANIFEST not in z.files:
            raise ValueError(f"{path}: not a checkpoint (no manifest)")
        manifest = json.loads(bytes(z[_MANIFEST].tobytes()).decode())
        if _GENERATOR not in z.files:
            raise ValueError(
                f"{path}: a checkpoint without a torch generator state"
                + (" (a JAX checkpoint: its PRNG key cannot seed a torch "
                   "generator; resume it with the JAX package, or from "
                   "its CSV with --from-csv)" if "key" in z.files else ""))
        gen_type = manifest["generator_device"]
        device = torch.device(gen_type if device is None else device)
        if device.type != gen_type:
            raise ValueError(f"{path}: a {gen_type} generator's state "
                             f"resumes on a {gen_type} device, not "
                             f"{device}")
        cls = _STATE_TYPES[manifest["state_class"]]
        values = {f: torch.as_tensor(z[f], device=device)
                  for f in manifest["fields"]}
        gen_state = torch.as_tensor(z[_GENERATOR])
    generator = torch.Generator(device=device)
    generator.set_state(gen_state)
    return cls(iteration=int(manifest["iteration"]), **values), generator
