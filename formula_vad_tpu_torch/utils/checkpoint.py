"""Checkpoint / resume for streaming state (port of ``formula_vad_tpu/
utils/checkpoint.py``).

The reference has no checkpointing: all state (ring buffers, rolling
averages, FSM, denoiser context) is in memory and lost on exit. The
streaming state here is an explicit carry (nested dicts of tensors, numpy
arrays and ``None``), so a daemon restart can resume mid-stream with
bit-identical downstream behaviour.

* ``save_carry`` / ``load_carry`` — any carry to/from one ``.npz``: each
  leaf under its path (``fsm/long_buf``), and a JSON entry
  ``__structure__`` recording the nesting, each leaf's kind (tensor or
  numpy) and the ``None`` leaves. Written with ``np.savez`` and read with
  ``allow_pickle=False``: no pickle, no package beyond numpy.
* ``save_train_state`` / ``load_train_state`` belong to training, which is
  not ported yet.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

STRUCTURE = "__structure__"


def _walk(carry: Any, prefix: str = ""):
    """(path, leaf) pairs of a nested dict, in key order."""
    if isinstance(carry, dict):
        for key, value in carry.items():
            if "/" in str(key):
                raise ValueError(f"carry key {key!r} contains '/'")
            yield from _walk(value, f"{prefix}{key}/")
    else:
        yield prefix[:-1], carry


def _kind(leaf: Any) -> str | None:
    if leaf is None:
        return None
    if torch.is_tensor(leaf):
        return "tensor"
    if isinstance(leaf, (np.ndarray, np.generic)):
        return "numpy"
    raise TypeError(f"unsupported carry leaf type {type(leaf).__name__}")


def _structure(carry: Any):
    if isinstance(carry, dict):
        return {k: _structure(v) for k, v in carry.items()}
    return _kind(carry)


def save_carry(path: str, carry: Any) -> None:
    """Serialize a carry (a dict of dicts of tensors, numpy arrays or None)
    to ``path`` (.npz). Tensors are copied to the host."""
    if not isinstance(carry, dict):
        raise TypeError("a carry is a dict")
    arrays = {
        name: leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
        for name, leaf in _walk(carry)
        if leaf is not None
    }
    if STRUCTURE in arrays:
        raise ValueError(f"carry key {STRUCTURE!r} is reserved")
    structure = np.frombuffer(json.dumps(_structure(carry)).encode(), dtype=np.uint8)
    np.savez(path, **{STRUCTURE: structure}, **arrays)


def _np_dtype(leaf: Any) -> np.dtype:
    if torch.is_tensor(leaf):
        return np.dtype(str(leaf.dtype).removeprefix("torch."))
    return np.asarray(leaf).dtype


def load_carry(path: str, template: Any) -> Any:
    """Restore a carry saved by ``save_carry`` into ``template``'s structure.

    Every leaf must match the template's path, shape and dtype, and the
    ``None`` leaves must be the same, or ``ValueError`` is raised. Tensor
    leaves return on the template leaf's device; numpy leaves stay numpy
    (int64 sample counters keep their width)."""
    with np.load(path, allow_pickle=False) as z:
        if STRUCTURE not in z.files:
            raise ValueError(f"{path}: not a carry checkpoint (no {STRUCTURE} entry)")
        saved = json.loads(bytes(z[STRUCTURE]).decode())
        want = _structure(template)
        if json.dumps(saved, sort_keys=True) != json.dumps(want, sort_keys=True):
            raise ValueError(f"{path}: carry structure {saved} != template {want}")
        restored = {}
        for name, leaf in _walk(template):
            if leaf is None:
                restored[name] = None
                continue
            a = z[name]
            if a.shape != tuple(leaf.shape) or a.dtype != _np_dtype(leaf):
                raise ValueError(
                    f"carry leaf {name}: checkpoint {a.shape} {a.dtype} vs template "
                    f"{tuple(leaf.shape)} {_np_dtype(leaf)}"
                )
            restored[name] = torch.from_numpy(a).to(leaf.device) if torch.is_tensor(leaf) else a
    return _unflatten(template, restored)


def _unflatten(template: Any, leaves: dict, prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/") for k, v in template.items()}
    return leaves[prefix[:-1]]


def _train_state_not_ported():
    return NotImplementedError(
        "training checkpoints are not ported yet (ROADMAP §1 item 10: training)"
    )


def save_train_state(directory: str, params: Any, opt_state: Any, step: int) -> None:
    raise _train_state_not_ported()


def load_train_state(directory: str, params_template: Any, opt_template: Any, step: int):
    raise _train_state_not_ported()
