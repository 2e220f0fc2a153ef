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
* ``save_train_state`` / ``load_train_state`` / ``latest_step`` — a
  network and its ``torch.optim.Adam`` (per parameter: the weights and
  Adam's step, exp_avg and exp_avg_sq) as ``step_<n>.npz`` carries, with
  ``latest.json`` naming the newest, as the JAX package's npz fallback
  (it tries orbax first; orbax is not used here). A network laid out over
  a training grid (``train/nsnet2_train.py::ShardedNSNet2``) is saved
  gathered and loaded through its shards, in the same format: a
  checkpoint resumes at any model-axis size, 1 included.
"""

from __future__ import annotations

import json
import os
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


def _named_state(net, optimizer) -> tuple[dict, dict]:
    """(name -> parameter, name -> Adam's state) in the unsharded layout: a
    sharded network gathers its own (``gathered_state``)."""
    if hasattr(net, "gathered_state"):
        return net.gathered_state(optimizer)
    named = list(net.named_parameters())
    return {name: p.detach() for name, p in named}, {name: optimizer.state.get(p, {}) for name, p in named}


def _train_carry(net, optimizer) -> dict:
    """The training state as a carry: each parameter under its name, and
    Adam's ``step``, ``exp_avg`` and ``exp_avg_sq`` of each. A parameter
    the optimizer has not stepped yet gets a zero state (step 0), which
    ``torch.optim.Adam`` treats as none."""
    named, states = _named_state(net, optimizer)
    params, adam = {}, {}
    for name, p in named.items():
        st = states[name]
        params[name] = p
        adam[name] = {
            "step": torch.as_tensor(st.get("step", 0.0), dtype=torch.get_default_dtype()).detach().cpu(),
            "exp_avg": st["exp_avg"] if "exp_avg" in st else torch.zeros_like(p),
            "exp_avg_sq": st["exp_avg_sq"] if "exp_avg_sq" in st else torch.zeros_like(p),
        }
    return {"params": params, "adam": adam}


def save_train_state(directory: str, net, optimizer, step: int) -> None:
    """Checkpoint a network and its ``torch.optim.Adam`` at ``step`` as
    ``step_<step>.npz`` in ``directory`` (``save_carry``: parameters, and
    per parameter Adam's step, exp_avg and exp_avg_sq), then point
    ``latest.json`` at it, as the JAX package's npz path does."""
    os.makedirs(directory, exist_ok=True)
    save_carry(os.path.join(directory, f"step_{step}.npz"), _train_carry(net, optimizer))
    with open(os.path.join(directory, "latest.json"), "w") as f:
        json.dump({"step": step}, f)


def latest_step(directory: str) -> int | None:
    """The step ``latest.json`` in ``directory`` names, or None."""
    path = os.path.join(directory, "latest.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["step"]


def load_train_state(directory: str, net, optimizer, step: int):
    """Restore the checkpoint of ``step`` into ``net`` and ``optimizer``
    (which give the structure, shapes and devices; ``load_carry`` raises
    ``ValueError`` on any mismatch) -> (net, optimizer). Adam's state is
    restored for every parameter saved with a nonzero step. A sharded
    network takes the unsharded checkpoint through its shards."""
    got = load_carry(os.path.join(directory, f"step_{step}.npz"), _train_carry(net, optimizer))
    if hasattr(net, "load_state"):
        adam = {name: st if float(st["step"]) > 0 else {} for name, st in got["adam"].items()}
        net.load_state(optimizer, got["params"], adam)
        return net, optimizer
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(got["params"][name])
            st = got["adam"][name]
            if float(st["step"]) > 0:
                optimizer.state[p] = {"step": st["step"], "exp_avg": st["exp_avg"], "exp_avg_sq": st["exp_avg_sq"]}
            else:
                optimizer.state.pop(p, None)
    return net, optimizer
