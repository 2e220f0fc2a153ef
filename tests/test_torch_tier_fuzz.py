"""The port's tier-fuzz campaign (``formula_vad_tpu_torch/testing/tier_fuzz.py``)
against the JAX package's, on the same random weights (the JAX
``init_params(PRNGKey(21))``, carried over through ``save_npz`` and the port's
``load_npz``), 40 cases of 16 chunks.

* Per case, both packages build the same FSM configuration, burst plan and
  rendered probe audio (bit for bit), and the port's ``highest`` segments
  equal the JAX campaign's ``highest`` segments.
* The port's own envelope is pinned to ``tests/test_tier_fuzz.py``'s bars:
  the campaign is non-vacuous; ``high`` (bf16_3x) has 0 deviated cases;
  ``bf16`` and ``bf16_io`` change no segment count, shift at most 10% of
  the boundaries and none by more than 2 windows. Unlike XLA:CPU, which
  computes every precision level in float32, the port rounds on the CPU as
  on the card: its bf16_3x, bf16 and bf16-storage products and its bf16
  recurrences (kernels 5 and 6's plain versions) run here.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from formula_vad_tpu.models import nsnet2 as jnsnet2
from formula_vad_tpu.pipeline import offline as joffline
from formula_vad_tpu.testing import tier_fuzz as jtier_fuzz
from formula_vad_tpu_torch.models import nsnet2, nsnet2_gates_cuda, registry
from formula_vad_tpu_torch.ops import precision
from formula_vad_tpu_torch.pipeline import offline
from formula_vad_tpu_torch.testing import tier_fuzz

N_CASES, N_CHUNKS, SEED_BASE = 40, 16, 600_000
TIER_OF = {  # (global level, io dtype) -> tier name
    ("highest", None): "highest",
    ("high", None): "high",
    ("default", None): "bf16",
    ("default", torch.bfloat16): "bf16_io",
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The campaign is thousands of small tensor ops, for which torch's
    intra-op threads only add overhead, and many of them when the test
    workers share the cores: one thread here, restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX params, port module) holding the same random weights."""
    jp = jnsnet2.init_params(jax.random.PRNGKey(21))
    path = str(tmp_path_factory.mktemp("weights") / "init21.npz")
    jnsnet2.save_npz(path, jp)
    return jp, nsnet2.load_npz(path)


def _recording(mp, module, tier_of) -> list:
    """Patch ``module.segments_from_offline`` to record (tier, boundaries)
    of every call; -> the list it fills."""
    calls = []
    segments_from_offline = module.segments_from_offline

    def record(st, win_out):
        out = segments_from_offline(st, win_out)
        calls.append((tier_of(), [(int(s["sample_from"]), int(s["sample_to"])) for s in out]))
        return out

    mp.setattr(module, "segments_from_offline", record)
    return calls


@pytest.fixture(scope="module")
def port_run(weights):
    """The port's campaign: (stats, {tier: [boundaries of each case]})."""
    with pytest.MonkeyPatch.context() as mp:
        calls = _recording(mp, offline, lambda: TIER_OF[(precision.matmul_precision(), precision.io_dtype())])
        stats = tier_fuzz.run_campaign(weights[1], n_cases=N_CASES, n_chunks=N_CHUNKS, seed_base=SEED_BASE)
    by_tier = {}
    for tier, segs in calls:
        by_tier.setdefault(tier, []).append(segs)
    return stats, by_tier


@pytest.fixture(scope="module")
def jax_highest(weights):
    """The JAX campaign's ``highest`` boundaries of each case (its other
    tiers left out: XLA:CPU computes them in float32)."""
    with pytest.MonkeyPatch.context() as mp:
        calls = _recording(mp, joffline, lambda: "highest")
        jtier_fuzz.run_campaign(weights[0], n_cases=N_CASES, n_chunks=N_CHUNKS, tiers=(), seed_base=SEED_BASE)
    return [segs for _, segs in calls]


def test_constants_match_jax():
    for name in ("SR", "FFT", "PROBE_AMP", "_SHAPE", "TIERS"):
        assert getattr(tier_fuzz, name) == getattr(jtier_fuzz, name), name


def _plan(module, case):
    rng = np.random.default_rng(SEED_BASE + case)
    cfg = module._case_config(rng)
    return cfg, module._burst_plan(rng, cfg, N_CHUNKS)


@pytest.mark.parametrize("case", range(N_CASES))
def test_case_plan_and_probe_audio_match_jax(case):
    cfg, plan = _plan(tier_fuzz, case)
    jcfg, jplan = _plan(jtier_fuzz, case)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert plan and plan == jplan
    assert [tier_fuzz._burst_windows(b) for b in plan] == [jtier_fuzz._burst_windows(b) for b in jplan]
    seed, amps = SEED_BASE + 7_000_000 + case, [tier_fuzz.PROBE_AMP] * len(plan)
    got = tier_fuzz._render(seed, plan, amps, N_CHUNKS)
    want = jtier_fuzz._render(seed, jplan, amps, N_CHUNKS)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("case", range(N_CASES))
def test_highest_segments_match_jax(port_run, jax_highest, case):
    got = port_run[1]["highest"]
    assert len(got) == len(jax_highest) == N_CASES
    assert got[case] == jax_highest[case]


def test_every_tier_ran_each_case(port_run):
    _, by_tier = port_run
    assert {tier: len(cases) for tier, cases in by_tier.items()} == dict.fromkeys(TIER_OF.values(), N_CASES)


def test_campaign_is_nonvacuous(port_run):
    base = port_run[0]["highest"]
    assert base.n_cases == N_CASES
    assert base.n_boundaries >= 40


def test_high_tier_zero_deviations(port_run):
    stats = port_run[0]
    s = stats["high"]
    assert s.n_cases == N_CASES
    assert s.deviated_cases == 0, tier_fuzz.format_table(stats)


@pytest.mark.parametrize("tier", ["bf16", "bf16_io"])
def test_fast_tier_envelope(port_run, tier):
    stats = port_run[0]
    s = stats[tier]
    assert s.n_cases == N_CASES
    assert s.seg_count_mismatch_cases == 0, tier_fuzz.format_table(stats)
    assert s.n_shifted_boundaries <= 0.10 * s.n_boundaries
    assert s.max_shift_windows <= 2, tier_fuzz.format_table(stats)


def test_format_table_matches_jax(port_run):
    stats = port_run[0]
    jstats = {t: jtier_fuzz.TierStats(**dataclasses.asdict(s)) for t, s in stats.items()}
    assert tier_fuzz.format_table(stats) == jtier_fuzz.format_table(jstats)
    print(tier_fuzz.format_table(stats))


def test_campaign_restores_the_float_tier(monkeypatch):
    """A tier that raises (here the bf16 tier, whose recurrence's plain
    version is made to fail) leaves the global switches at ``highest`` and
    float32 storage."""
    net = registry.load_denoiser("random", device="cpu")

    def fail(*args, **kw):
        raise RuntimeError("the bf16 recurrence failed")

    monkeypatch.setattr(nsnet2_gates_cuda, "gru_gates_p_reference", fail)
    with pytest.raises(RuntimeError, match="bf16 recurrence"):
        tier_fuzz.run_campaign(net, n_cases=1, n_chunks=N_CHUNKS, tiers=tier_fuzz.TIERS[1:])
    assert precision.matmul_precision() == "highest" and precision.io_dtype() is None


def test_high_moves_a_near_tie_of_the_demo_campaign():
    """ROADMAP §3 item 6, pinned: on the demo weights, case 104 of the
    240-case campaign sits within bf16_3x's precision of a decision (its
    margin is 3e-6 to 1e-5 of the window volume; 'high' moves the window
    volumes by ~5e-6), and 'high' widens one of its segments by one window
    at each end. It is the only case of the 240 that 'high' moves on the
    CPU (PERF.md §6)."""
    net = registry.load_denoiser("demo", device="cpu")
    stats = tier_fuzz.run_campaign(net, n_cases=1, n_chunks=N_CHUNKS, seed_base=SEED_BASE + 104,
                                   tiers=tier_fuzz.TIERS[:1])
    s = stats["high"]
    assert (s.n_cases, s.seg_count_mismatch_cases, s.n_shifted_boundaries, s.max_shift_windows) == (1, 0, 2, 1), s
