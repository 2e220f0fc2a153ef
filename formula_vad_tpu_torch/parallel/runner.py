"""Batched multi-stream VAD runner over a data mesh (port of
``formula_vad_tpu/parallel/runner.py::BatchRunner``).

All streams form the leading batch axis, sharded over the mesh
(``parallel/mesh.py``): the batch is padded with all-invalid streams to a
multiple of the mesh's size, each shard's rows go to its device and run the
path below on that device's copy of the model, every shard is dispatched
before any is fetched, and the outputs are fetched once a shard and
gathered across processes, so every process returns all B results. The
default mesh is every visible card when the model is on a card (one card:
one shard, the unsharded path) and the model's CPU when it is on the CPU.
Ragged lengths are right-padded
to a common chunk count and masked, so padding windows freeze the FSM.
With ``use_offline=True`` (the default) one chunk-parallel front-end pass
feeds one FSM scan, the device kernel (``use_host_fsm=False``, the
default) or the native host decoder. With ``use_offline=False`` the
streams are stepped chunk by chunk (``vad.process_stream``): one
``chunk_step`` a chunk for all B streams, the FSM carry chained on the
card, and one fetch of the outputs after the loop.

``alt_vad_machine_configs`` (the reference's parameter sweep) give each
stream K more state machines, whose segments come back in
``StreamResult.alt_segments``, one list a config. The front end runs once:
the primary machine and the K alternatives are 1 + K (stream, config) rows
a stream, stream-major, of one FSM scan (``vad.stack_machine_params``,
``fsm.tile_rows``), on every path. The JAX ``BatchRunner`` recomputes the
whole front end for the alternative machines; their inputs are the same,
so the segments are too. This is a change of schedule, not of function:
each machine's row is scanned exactly as a machine of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import VADConfig
from ..device import model_device
from ..pipeline import fsm, fsm_host, offline, vad
from . import mesh as mesh_lib


@dataclasses.dataclass
class StreamResult:
    """One stream's segments (dicts with sample_from/sample_to/
    avg_channel_vol_ratio/vad_met_sec), and one such list an alternative
    machine config."""

    segments: list[dict]
    alt_segments: list[list[dict]] = dataclasses.field(default_factory=list)


def results(st: vad.VADStatics, win_out: fsm.WindowOutput, k: int) -> list[StreamResult]:
    """StreamResults from numpy window outputs [B, W] or, for 1 + k machines
    a stream (the primary first), [B, (n_chunks,) 1 + k, W]."""
    def segments(i, m=None):
        pick = (lambda x: x[i]) if m is None else (lambda x: x[i][..., m, :])
        return vad.segments_from_outputs(st, type(win_out)(*(pick(x) for x in win_out)))

    b = win_out.event.shape[0]
    if not k:
        return [StreamResult(segments(i)) for i in range(b)]
    return [StreamResult(segments(i, 0), [segments(i, m) for m in range(1, k + 1)]) for i in range(b)]


class BatchRunner:
    def __init__(
        self,
        net: nn.Module,
        vad_config: VADConfig | None = None,
        n_channels: int = 2,
        sample_rate: int = 48000,
        mesh: mesh_lib.DataMesh | None = None,
        use_mesh: bool = True,
        use_host_fsm: bool = False,
        use_offline: bool = True,
    ):
        vad_config = vad_config or VADConfig()
        if use_host_fsm and not use_offline:
            raise ValueError("use_host_fsm decodes the offline path's window inputs: it needs use_offline=True")
        self.net = net
        self.device = model_device(net)
        self.mesh = mesh_lib.default_mesh(mesh, use_mesh, self.device)
        self.nets = mesh_lib.replicate(net, self.mesh)
        self.use_host_fsm = use_host_fsm
        self.use_offline = use_offline
        self.st = vad.statics_from_config(vad_config, sample_rate, n_channels)
        self.alt_configs = tuple(vad_config.alt_vad_machine_configs or ())
        self.machines = vad.machines_of(self.st, vad_config)

    def run(self, audio_batch: np.ndarray, lengths: Optional[Sequence[int]] = None) -> list[StreamResult]:
        """audio_batch [B, C, T] float32 (padded to a common T); lengths are
        the true per-stream sample counts (default: all T). Only whole
        chunks are scored."""
        if self.use_host_fsm and self.mesh.n_processes > 1:
            raise ValueError(
                "use_host_fsm requires a single process: multi-process outputs are sharded across hosts "
                "(leave use_host_fsm unset to get the device-FSM path)"
            )
        b, _, t = audio_batch.shape
        chunk = self.st.chunk_size
        n_chunks = t // chunk
        if n_chunks == 0:
            return [StreamResult([], [[] for _ in self.alt_configs]) for _ in range(b)]
        if lengths is None:
            lengths = [t] * b
        n_valid = np.asarray([n // chunk for n in lengths], np.int32)
        audio = audio_batch[:, :, : n_chunks * chunk]
        b_pad = mesh_lib.pad_batch(b, self.mesh)
        with torch.inference_mode():
            pending = [
                self._dispatch(dev, _rows(audio, rows, b), _rows(n_valid, rows, b))
                for dev, rows in mesh_lib.local_shards(self.mesh, b_pad)
            ]
            outs = mesh_lib.gather_rows([[x.cpu().numpy() for x in out] for out in pending], self.mesh)
        k = len(self.alt_configs)
        if self.use_host_fsm:
            params = self.st.fsm_params if self.machines is None else self.machines
            _, expand, row_params = fsm.machine_rows(params, b)
            win_out, _ = fsm_host.scan_windows_host(self.st.fsm_shape, row_params, *(expand(x[:b]) for x in outs))
            if k:
                win_out = type(win_out)(*(x.reshape(b, k + 1, -1) for x in win_out))
        else:
            win_out = fsm.WindowOutput(*(x[:b] for x in outs))
        return results(self.st, win_out, k)

    def _dispatch(self, dev: torch.device, audio: np.ndarray, n_valid: np.ndarray):
        """Queue one shard's path on ``dev``: -> its FSM outputs ([rows,
        (n_chunks,) (1 + k,) W], on the device), or with the host decoder
        its window inputs."""
        net, st = self.nets[dev], self.st
        params = st.fsm_params if self.machines is None else self.machines
        with mesh_lib.on(dev):
            valid_chunks = torch.from_numpy(n_valid).to(dev)
            x = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(dev)
            if not self.use_offline:
                chunk_valids = np.arange(x.shape[-1] // st.chunk_size)[None, :] < n_valid[:, None]
                _, outs = vad.process_stream(net, st, x, chunk_valids=chunk_valids, fsm_params=params)
                return outs.windows
            if self.use_host_fsm:
                return offline.window_inputs_batch(net, st, x, valid_chunks)
            win_out, _ = offline.process_batch_offline(net, st, x, valid_chunks, params)
            return win_out


def _rows(x: np.ndarray, rows: slice, b: int) -> np.ndarray:
    """``x[rows]`` of a batch of ``b`` rows, the rows at and past ``b``
    (the mesh's padding) zeros: a stream with no valid chunk."""
    part = x[rows.start : min(rows.stop, b)]
    pad = rows.stop - rows.start - len(part)
    if pad:
        part = np.concatenate([part, np.zeros((pad,) + x.shape[1:], x.dtype)])
    return part
