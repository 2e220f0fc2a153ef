"""Batched multi-stream VAD runner on one device (port of
``formula_vad_tpu/parallel/runner.py::BatchRunner``, single device, no mesh).

All streams form the leading batch axis; ragged lengths are right-padded
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
        use_host_fsm: bool = False,
        use_offline: bool = True,
    ):
        vad_config = vad_config or VADConfig()
        if use_host_fsm and not use_offline:
            raise ValueError("use_host_fsm decodes the offline path's window inputs: it needs use_offline=True")
        self.net = net
        self.device = model_device(net)
        self.use_host_fsm = use_host_fsm
        self.use_offline = use_offline
        self.st = vad.statics_from_config(vad_config, sample_rate, n_channels)
        self.alt_configs = tuple(vad_config.alt_vad_machine_configs or ())
        self.machines = vad.machines_of(self.st, vad_config)

    def run(self, audio_batch: np.ndarray, lengths: Optional[Sequence[int]] = None) -> list[StreamResult]:
        """audio_batch [B, C, T] float32 (padded to a common T); lengths are
        the true per-stream sample counts (default: all T). Only whole
        chunks are scored."""
        b, _, t = audio_batch.shape
        chunk = self.st.chunk_size
        n_chunks = t // chunk
        if n_chunks == 0:
            return [StreamResult([], [[] for _ in self.alt_configs]) for _ in range(b)]
        if lengths is None:
            lengths = [t] * b
        n_valid = np.asarray([n // chunk for n in lengths], np.int32)
        valid_chunks = torch.from_numpy(n_valid).to(self.device)
        audio = torch.from_numpy(np.ascontiguousarray(audio_batch[:, :, : n_chunks * chunk], np.float32))
        audio = audio.to(self.device)
        st = self.st
        k = len(self.alt_configs)
        params = st.fsm_params if self.machines is None else self.machines
        with torch.inference_mode():
            if not self.use_offline:
                chunk_valids = np.arange(n_chunks)[None, :] < n_valid[:, None]
                _, outs = vad.process_stream(self.net, st, audio, chunk_valids=chunk_valids, fsm_params=params)
                win_out = type(outs.windows)(*(x.cpu().numpy() for x in outs.windows))  # [B, chunks, (1 + k,) W]
            elif self.use_host_fsm:
                _, expand, row_params = fsm.machine_rows(params, b)
                inputs = (expand(x.cpu().numpy()) for x in offline.window_inputs_batch(self.net, st, audio, valid_chunks))
                win_out, _ = fsm_host.scan_windows_host(st.fsm_shape, row_params, *inputs)
                if k:
                    win_out = type(win_out)(*(x.reshape(b, k + 1, -1) for x in win_out))
            else:
                win_out, _ = offline.process_batch_offline(self.net, st, audio, valid_chunks, params)
                win_out = type(win_out)(*(x.cpu().numpy() for x in win_out))
        return results(st, win_out, k)
