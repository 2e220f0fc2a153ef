"""Denoising quality (``eval/denoise_quality.py``) against the JAX
package's: the SI-SDR metric, the held-out (noisy, clean) pairs from
``synth_stream(components=True)`` bit for bit, and ``evaluate`` on the same
pairs within 0.05 dB per number (the JAX module rounds each to 0.01 dB; the
port's chunk loop and XLA's scan round float32 products in other orders).
The port's own ranking and floors are the JAX tests' (tests/
test_denoise_quality.py): demo > spectral_gate > random, random < 3 dB.
"""

import numpy as np
import pytest
import torch

from formula_vad_tpu.eval import denoise_quality as jdq
from formula_vad_tpu.models import registry as jregistry
from formula_vad_tpu.testing import synth as jsynth
from formula_vad_tpu_torch.eval import denoise_quality as dq
from formula_vad_tpu_torch.models import registry
from formula_vad_tpu_torch.testing import synth

DB_TOL = 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small tensor ops, for which torch's intra-op threads only add
    overhead when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_si_sdr_metric_properties():
    rng = np.random.default_rng(0)
    ref = rng.standard_normal(4800).astype(np.float32)
    assert dq.si_sdr(ref, ref) > 100.0
    assert dq.si_sdr(2.5 * ref, ref) > 100.0  # scale invariance
    noise = rng.standard_normal(4800).astype(np.float32)
    noise *= np.linalg.norm(ref) / np.linalg.norm(noise) / (10**0.5)
    assert dq.si_sdr(ref + noise, ref) == pytest.approx(10.0, abs=1.5)
    assert dq.si_sdr(noise, ref) < -5.0
    for est in (ref + noise, noise, 0.3 * ref - noise):
        assert dq.si_sdr(est, ref) == jdq.si_sdr(est, ref)
    with pytest.raises(ValueError):
        dq.si_sdr(ref, np.zeros(4800))


@pytest.mark.parametrize("seed, seconds", [(20_000, 12.0), (20_001, 12.0), (20_002, 20.0)])
def test_synth_components_bit_for_bit(seed, seconds):
    """``components=True`` returns the JAX generator's three values bit for
    bit (seed 20,001 at 12 s draws no burst: an all-zero clean signal), and
    the two-value call draws the same audio and labels."""
    got = synth.synth_stream(np.random.default_rng(seed), seconds, components=True)
    want = jsynth.synth_stream(np.random.default_rng(seed), seconds, components=True)
    assert len(got) == 3 and got[1] == want[1]
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
    audio, labels = synth.synth_stream(np.random.default_rng(seed), seconds)
    assert audio.tobytes() == got[0].tobytes() and labels == got[1]
    assert bool(np.any(got[2])) == bool(got[1])


def test_held_out_pairs_and_the_identity_pipeline():
    """The JAX package's pairs, and the unity-gain pipeline reconstructs its
    input's energy within 25% (the decimation round trip)."""
    ((noisy, clean),) = dq.held_out_pairs(1, 12.0)
    ((jnoisy, jclean),) = jdq.held_out_pairs(1, 12.0)
    assert noisy.tobytes() == jnoisy.tobytes() and clean.tobytes() == jclean.tobytes()
    out = dq.pipeline_denoise(dq.IdentityGains(), clean, device="cpu")
    assert out.shape == (2, clean.shape[1])
    assert float(np.sum(out**2)) == pytest.approx(float(np.sum(clean[:, : out.shape[1]] ** 2)), rel=0.25)
    with pytest.raises(ValueError, match="too short"):
        dq.held_out_pairs(1, 6.0)


@pytest.mark.parametrize("spec", ["demo", "spectral_gate"])
def test_evaluate_matches_the_jax_evaluate(spec):
    got = dq.evaluate(registry.load_denoiser(spec, device="cpu"), n_pairs=1, seconds=10.0, device="cpu")
    want = jdq.evaluate(jregistry.load_denoiser(spec), n_pairs=1, seconds=10.0)
    assert {k: got[k] for k in ("n_pairs", "seconds", "seed")} == {k: want[k] for k in ("n_pairs", "seconds", "seed")}
    for g, w in zip(got["pairs"] + [got], want["pairs"] + [want]):
        for key in ("si_sdr_noisy_db", "si_sdr_denoised_db", "si_sdr_impr_db", "mean_si_sdr_impr_db"):
            if key in w:
                assert abs(g[key] - w[key]) <= DB_TOL, (key, g, w)


def test_ranking_and_floors():
    """1 pair x 16 s, as the JAX ranking test: demo > gate > random, the
    random weights below 3 dB, the demo's and the gate's JAX floors."""
    res = {spec: dq.evaluate(registry.load_denoiser(spec, device="cpu"), n_pairs=1, seconds=16.0, device="cpu")
           for spec in ("demo", "spectral_gate", "random")}
    demo, gate, rand = (res[s]["mean_si_sdr_impr_db"] for s in ("demo", "spectral_gate", "random"))
    assert demo > gate > rand, res
    assert rand < 3.0 and demo >= 15.0 and gate >= 3.0, res
    assert all(row["si_sdr_impr_db"] >= 10.0 for row in res["demo"]["pairs"]), res
