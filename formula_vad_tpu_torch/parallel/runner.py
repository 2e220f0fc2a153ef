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
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import VADConfig
from ..models.nsnet2 import NSNet2
from ..pipeline import fsm_host, offline, vad


@dataclasses.dataclass
class StreamResult:
    """One stream's segments (dicts with sample_from/sample_to/
    avg_channel_vol_ratio/vad_met_sec)."""

    segments: list[dict]


class BatchRunner:
    def __init__(
        self,
        net: NSNet2,
        vad_config: VADConfig | None = None,
        n_channels: int = 2,
        sample_rate: int = 48000,
        use_host_fsm: bool = False,
        use_offline: bool = True,
    ):
        vad_config = vad_config or VADConfig()
        if use_host_fsm and not use_offline:
            raise ValueError("use_host_fsm decodes the offline path's window inputs: it needs use_offline=True")
        if vad_config.alt_vad_machine_configs:
            raise NotImplementedError(
                "alt_vad_machine_configs are not ported yet (ROADMAP: port queue, apps/tune.py and the alt-config rows)"
            )
        self.net = net
        self.device = next(net.parameters()).device
        self.use_host_fsm = use_host_fsm
        self.use_offline = use_offline
        self.st = vad.statics_from_config(vad_config, sample_rate, n_channels)

    def run(self, audio_batch: np.ndarray, lengths: Optional[Sequence[int]] = None) -> list[StreamResult]:
        """audio_batch [B, C, T] float32 (padded to a common T); lengths are
        the true per-stream sample counts (default: all T). Only whole
        chunks are scored."""
        b, _, t = audio_batch.shape
        chunk = self.st.chunk_size
        n_chunks = t // chunk
        if n_chunks == 0:
            return [StreamResult(segments=[]) for _ in range(b)]
        if lengths is None:
            lengths = [t] * b
        n_valid = np.asarray([n // chunk for n in lengths], np.int32)
        valid_chunks = torch.from_numpy(n_valid).to(self.device)
        audio = torch.from_numpy(np.ascontiguousarray(audio_batch[:, :, : n_chunks * chunk], np.float32))
        audio = audio.to(self.device)
        st = self.st
        with torch.inference_mode():
            if not self.use_offline:
                chunk_valids = np.arange(n_chunks)[None, :] < n_valid[:, None]
                _, outs = vad.process_stream(self.net, st, audio, chunk_valids=chunk_valids)
                win_out = type(outs.windows)(*(x.cpu().numpy() for x in outs.windows))  # [B, K, W]
            elif self.use_host_fsm:
                mv, rt, va = offline.window_inputs_batch(self.net, st, audio, valid_chunks)
                win_out, _ = fsm_host.scan_windows_host(
                    st.fsm_shape, st.fsm_params, mv.cpu().numpy(), rt.cpu().numpy(), va.cpu().numpy()
                )
            else:
                win_out, _ = offline.process_batch_offline(self.net, st, audio, valid_chunks)
                win_out = type(win_out)(*(x.cpu().numpy() for x in win_out))
        return [
            StreamResult(segments=vad.segments_from_outputs(st, type(win_out)(*(x[i] for x in win_out))))
            for i in range(b)
        ]
