"""The port's daemons on the CPU: ``apps/daemon.py`` (one stream) and
``apps/multidaemon.py`` (a fleet behind ``OnlineBatchServer``) against the
JAX package's solo daemon on the same script of commands, their
checkpoints, and the multiplexer's own protocol.

Both packages load the packaged demo weights (``--denoiser demo``, one
file read by each package's registry). The corpus: two windows of
synthetic streams, not chunk-aligned, each around one speech burst: the
first ends inside its recording's closing margin, so that the recording
stays in flight across commands; the second holds a whole recording. Bars: events equal line for line (output directories scrubbed);
original WAVs byte for byte; denoised WAVs within 3e-5, the JAX package's
own bar between its chunked and offline denoisers (tests/test_offline.py).
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from formula_vad_tpu.apps.daemon import Daemon as JDaemon
from formula_vad_tpu_torch.apps import daemon as daemon_mod
from formula_vad_tpu_torch.apps import multidaemon as multidaemon_mod
from formula_vad_tpu_torch.apps.daemon import Daemon
from formula_vad_tpu_torch.apps.multidaemon import MultiDaemon
from formula_vad_tpu_torch.io_.audio import AudioBuffer
from formula_vad_tpu_torch.io_.wav import write_wav
from formula_vad_tpu_torch.testing.synth import synth_stream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECONDS = 12.37  # synthesized, then cut to WINDOWS
WINDOWS = ((3.0, 9.87), (0.0, 8.87))  # seconds: 14 chunks and a 1,760-sample tail; 17 and a 17,760 one
DENOISED_ATOL = 3e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("daemon_corpus")
    rng = np.random.default_rng(31)
    paths = []
    for i, (a, b) in enumerate(WINDOWS):
        audio, _ = synth_stream(rng, SECONDS)
        paths.append(str(d / f"s{i}.wav"))
        write_wav(paths[-1], audio[:, int(a * 48000) : int(b * 48000)], 48000)
        if i == 1:  # a short segment of noise from the same stream
            short = str(d / "short.wav")
            write_wav(short, audio[:, : int(2.37 * 48000)], 48000)
    bad = str(d / "bad_sr.wav")
    write_wav(bad, np.zeros((2, 4410), np.float32), 44100)
    return {"wavs": paths, "short": short, "bad_sr": bad}


def solo_script(wavs):
    """The solo daemon's commands: a segment whose recording is still in
    flight at its end, malformed lines, a skip that completes it."""
    return [
        json.dumps({"action": "segment", "file_path": wavs[0], "playhead_timestamp_ms": 1000}),
        "this is not json",
        json.dumps({"action": "bogus"}),
        json.dumps({"action": "segment", "playhead_timestamp_ms": 5}),
        json.dumps({"action": "segment", "file_path": "/nonexistent.wav", "playhead_timestamp_ms": 0}),
        json.dumps({"action": "segment", "file_path": wavs[0], "playhead_timestamp_ms": "1000"}),
        json.dumps({"action": "skip_segment"}),
    ]


def multi_script(wavs):
    """The multidaemon's: stream "a" gets the solo script's commands in
    order, then stream "b" a segment and a skip, between stats requests,
    with an unknown stream's command. A checkpoint every 2 commands."""
    a = [dict(json.loads(line), stream="a") if line.startswith("{") else line for line in solo_script(wavs)]
    cmds = [
        {"action": "stats"},
        *a,
        {"action": "segment", "stream": "b", "file_path": wavs[1], "playhead_timestamp_ms": 700},
        {"action": "segment", "stream": "nope", "file_path": wavs[0], "playhead_timestamp_ms": 0},
        {"action": "skip_segment", "stream": "b"},
        {"action": "stats"},
    ]
    return [c if isinstance(c, str) else json.dumps(c) for c in cmds]


def _lines(out, out_dir):
    return [line.replace(out_dir, "OUT") for line in out.getvalue().splitlines() if line.strip()]


def _run_solo(cls, out_dir, script, **kw):
    os.makedirs(out_dir)
    out = io.StringIO()
    d = cls("SOLO", out_dir, "demo", stdout=out, **kw)
    for line in script:
        d.process_line(line)
    return _lines(out, out_dir)


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """The JAX solo daemon, the port's solo daemon, and the port's
    multidaemon (with --state and a checkpoint every 2 commands: the
    uninterrupted run the resume tests are held to), each over its script."""
    root = tmp_path_factory.mktemp("daemon_runs")
    wavs = corpus["wavs"]
    out = {
        "jax": _run_solo(JDaemon, str(root / "jax"), solo_script(wavs)),
        "port": _run_solo(Daemon, str(root / "port"), solo_script(wavs), device="cpu"),
    }
    multi_dir = str(root / "multi")
    os.makedirs(multi_dir)
    buf = io.StringIO()
    md = MultiDaemon("MULTI", multi_dir, ["a", "b"], "demo", stdout=buf, state_dir=str(root / "multi_state"),
                     checkpoint_every=2, device="cpu")
    assert md.run(stdin=io.StringIO("".join(line + "\n" for line in multi_script(wavs)))) == 0
    out["multi"] = _lines(buf, multi_dir)
    out["dirs"] = {"jax": str(root / "jax"), "port": str(root / "port"), "multi_a": os.path.join(multi_dir, "a")}
    return out


def test_solo_daemon_events_equal_the_jax_daemon(runs):
    assert runs["port"] == runs["jax"]
    events = [json.loads(line) for line in runs["jax"]]
    assert sum(e["action"] == "recording" for e in events) >= 1
    assert sum(e["action"] == "error" for e in events) == 5 and not any(e["fatal"] for e in events if "fatal" in e)


def test_multidaemon_stream_equals_the_solo_daemon(runs):
    """Stream "a" of the multidaemon: the solo daemon's events, each with
    its stream field (also in the command an error quotes) and under
    OUT/a/, but for the unparsable line, which names no stream."""
    events = [json.loads(line) for line in runs["multi"]]
    mine = []
    for e in events:
        if e.get("stream") == "a" and e["action"] in ("recording", "error"):
            e = {k: v for k, v in e.items() if k != "stream"}
            if e["action"] == "error":
                e["message"] = e["message"].replace(", 'stream': 'a'", "")
            mine.append(e)
    solo = [json.loads(line.replace("OUT/", "OUT/a/")) for line in runs["port"] if "Error parsing" not in line]
    for e in solo:
        if e["action"] == "recording":
            e["name"] = "MULTI"
    assert mine == solo
    assert any(e.get("stream") == "b" and e["action"] == "recording" for e in events)


def test_multidaemon_stats_and_checkpoint_acks(runs):
    events = [json.loads(line) for line in runs["multi"]]
    stats = [e for e in events if e["action"] == "stats"]
    assert len(stats) == 2
    first, last = stats
    assert first["ticks"] == 0 and "last_ms" not in first and first["streams"] == 2 and first["budget_ms"] == 500.0
    assert last["ticks"] > 0 and last["p50_ms"] <= last["p95_ms"] <= last["max_ms"]
    assert last["dropped"] == [] and last["commands_processed"] == len(multi_script(["x", "y"])) - 1
    acks = [e["commands_processed"] for e in events if e["action"] == "checkpoint"]
    assert acks == list(range(2, len(multi_script(["x", "y"])) + 1, 2))
    unknown = [e for e in events if e["action"] == "error" and "nope" in e["message"]]
    assert len(unknown) == 1 and "stream" not in unknown[0]


def _wavs(directory, kind):
    return {n: AudioBuffer.load_from_file(os.path.join(directory, n)) for n in sorted(os.listdir(directory))
            if n.endswith(f"-{kind}.wav")}


@pytest.mark.parametrize("port", ["port", "multi_a"])
def test_daemon_wavs_against_the_jax_daemon(runs, port):
    """Original WAVs byte for byte, denoised ones within 3e-5, with the
    same names (start frames)."""
    want_dir, got_dir = runs["dirs"]["jax"], runs["dirs"][port]
    names = sorted(n for n in os.listdir(want_dir) if n.endswith(".wav"))
    assert names and sorted(n for n in os.listdir(got_dir) if n.endswith(".wav")) == names
    for n in names:
        if n.endswith("-original.wav"):
            with open(os.path.join(got_dir, n), "rb") as g, open(os.path.join(want_dir, n), "rb") as w:
                assert g.read() == w.read(), n
    got, want = _wavs(got_dir, "denoised"), _wavs(want_dir, "denoised")
    for n, w in want.items():
        assert got[n].channel_pcm.shape == w.channel_pcm.shape
        np.testing.assert_allclose(got[n].channel_pcm, w.channel_pcm, rtol=0, atol=DENOISED_ATOL, err_msg=n)


def test_multidaemon_generation_resume_equals_the_uninterrupted_run(corpus, runs, tmp_path):
    """The same commands split across a restart with --state: the events of
    the uninterrupted run, checkpoint acks included, up to the last command
    run; the resumed process continues the generation count."""
    script = multi_script(corpus["wavs"])
    out_dir, state = str(tmp_path / "out"), str(tmp_path / "state")
    os.makedirs(out_dir)
    buf = io.StringIO()
    k = 2  # stream "a" has a recording in flight here
    md1 = MultiDaemon("MULTI", out_dir, ["a", "b"], "demo", stdout=buf, state_dir=state, checkpoint_every=2,
                      device="cpu")
    md1.run(stdin=io.StringIO("".join(line + "\n" for line in script[:k])))
    assert md1.server.pipelines[0].original_recorder.recording
    md2 = MultiDaemon("MULTI", out_dir, ["a", "b"], "demo", stdout=buf, state_dir=state, checkpoint_every=2,
                      device="cpu")
    md2.run(stdin=io.StringIO("".join(line + "\n" for line in script[k:8])))
    # The uninterrupted run's events up to the ack of command 8, the last
    # one run (stream "a"'s skip, which completes its recording).
    ack_8 = runs["multi"].index(json.dumps({"action": "checkpoint", "commands_processed": 8}))
    got = _lines(buf, out_dir)
    assert got == runs["multi"][: ack_8 + 1] and any('"recording"' in line for line in got)
    entries = sorted(os.listdir(state))
    assert [e for e in entries if e.startswith("gen-")] == [open(os.path.join(state, "LATEST")).read()]
    assert int(entries[-1].split("-")[1]) == 8 // 2 + 2  # a save every 2 commands, and one at each exit


def test_multidaemon_rejects_another_fleet_s_checkpoint(runs, tmp_path):
    state = str(tmp_path / "state")
    buf = io.StringIO()
    MultiDaemon("M", str(tmp_path), ["x"], "demo", stdout=buf, state_dir=state, device="cpu").run(stdin=io.StringIO(""))
    buf = io.StringIO()
    rc = MultiDaemon("M", str(tmp_path), ["x", "z"], "demo", stdout=buf, state_dir=state, device="cpu").run(
        stdin=io.StringIO(""))
    errs = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert rc == 1 and errs[0]["fatal"] and "streams" in errs[0]["message"]


def test_multidaemon_sr_mismatch_drops_only_that_stream(corpus, tmp_path):
    out = io.StringIO()
    md = MultiDaemon("M", str(tmp_path), ["x", "y"], "demo", stdout=out, device="cpu")
    md.process_line(json.dumps({"action": "segment", "stream": "x", "file_path": corpus["bad_sr"],
                                "playhead_timestamp_ms": 0}))
    events = [json.loads(line) for line in out.getvalue().splitlines()]
    assert events[-1]["fatal"] and events[-1]["stream"] == "x" and "SR of 44100" in events[-1]["message"]
    assert md.dropped == {"x"}
    md.process_line(json.dumps({"action": "skip_segment", "stream": "x"}))
    events = [json.loads(line) for line in out.getvalue().splitlines()]
    assert not events[-1]["fatal"] and "dropped" in events[-1]["message"]
    md.process_line(json.dumps({"action": "skip_segment", "stream": "y"}))
    assert len(out.getvalue().splitlines()) == 2


def test_multidaemon_protocol_errors_are_not_fatal(tmp_path):
    out = io.StringIO()
    md = MultiDaemon("M", str(tmp_path), ["x"], "demo", stdout=out, device="cpu")
    for line in (
        "not json",
        json.dumps({"action": "segment", "file_path": "f.wav"}),
        json.dumps({"action": "segment", "stream": "nope", "file_path": "f.wav"}),
        json.dumps({"action": "bogus", "stream": "x"}),
        json.dumps({"action": "segment", "stream": "x"}),
        json.dumps({"action": "segment", "stream": "x", "file_path": "f.wav"}),
        json.dumps({"action": "segment", "stream": "x", "file_path": "/nonexistent.wav", "playhead_timestamp_ms": 0}),
    ):
        md.process_line(line)
    events = [json.loads(line) for line in out.getvalue().splitlines()]
    assert len(events) == 7 and all(e["action"] == "error" and not e["fatal"] for e in events)
    assert "Missing file_path" in events[4]["message"] and "Missing playhead_timestamp_ms" in events[5]["message"]


def test_orphaned_staging_dirs_are_pruned(tmp_path):
    """A crash mid-save leaves a .stage-<pid> directory; the next completed
    save prunes it and superseded generations."""
    state = tmp_path / "state"
    (state / ".stage-99999").mkdir(parents=True)
    (state / ".stage-99999" / "carries.npz").write_bytes(b"torn write from a killed process")
    (state / "gen-00000001-99999").mkdir()
    md = MultiDaemon("M", str(tmp_path), ["x"], "demo", stdout=io.StringIO(), state_dir=str(state), device="cpu")
    md.run(stdin=io.StringIO(json.dumps({"action": "skip_segment", "stream": "x"}) + "\n"))
    entries = sorted(os.listdir(state))
    assert entries == ["LATEST", (state / "LATEST").read_text()], entries


def test_solo_daemon_state_resume_and_refusal(corpus, tmp_path):
    """--state: a checkpoint written on exit (mid-recording) resumes to the
    uninterrupted run's events; an unreadable one is fatal and left as it is.
    The checkpoint holds the pipeline only, as the JAX daemon's does: the
    playhead correlation restarts at (0, 0), which the first segment's
    playhead 0 makes the same."""
    cmds = [json.dumps({"action": "segment", "file_path": corpus["wavs"][0], "playhead_timestamp_ms": 0}),
            json.dumps({"action": "segment", "file_path": corpus["short"], "playhead_timestamp_ms": 20000})]
    ref = io.StringIO()
    d = Daemon("S", str(tmp_path), "demo", stdout=ref, device="cpu")
    for line in cmds:
        d.process_line(line)
    state = str(tmp_path / "state.npz")
    out = io.StringIO()
    d1 = Daemon("S", str(tmp_path), "demo", stdout=out, state_path=state, device="cpu")
    assert d1.run(stdin=io.StringIO(cmds[0] + "\n")) == 0
    assert d1.pipeline.original_recorder.recording
    d2 = Daemon("S", str(tmp_path), "demo", stdout=out, state_path=state, device="cpu")
    assert d2.run(stdin=io.StringIO(cmds[1] + "\n")) == 0
    assert out.getvalue() == ref.getvalue() and "recording" in ref.getvalue()

    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not an npz checkpoint")
    out = io.StringIO()
    rc = Daemon("S", str(tmp_path), "demo", stdout=out, state_path=str(bad), device="cpu").run(stdin=io.StringIO(""))
    assert rc == 1 and json.loads(out.getvalue())["fatal"]
    assert bad.read_bytes() == b"not an npz checkpoint"


@pytest.mark.parametrize("entry", [daemon_mod, multidaemon_mod], ids=["daemon", "multidaemon"])
@pytest.mark.parametrize(
    "spec",
    # The gate and ONNX files load now: the gate's case is a malformed gate
    # spec, the ONNX case a missing file.
    [pytest.param("spectral_gate:0.1", id="spectral_gate"), "weights.onnx", "missing.npz", "bogus"],
)
def test_unloadable_denoiser_is_a_fatal_start_up_error(entry, spec, tmp_path, capsys):
    argv = ["-o", str(tmp_path), "-n", "N", "--denoiser", spec, "--device", "cpu"]
    if entry is multidaemon_mod:
        argv += ["--streams", "x"]
    assert entry.main(argv) == 2
    (line,) = capsys.readouterr().out.splitlines()
    event = json.loads(line)
    assert event["action"] == "error" and event["fatal"] and event["message"].startswith("Could not")


@pytest.mark.parametrize("entry", [daemon_mod, multidaemon_mod], ids=["daemon", "multidaemon"])
def test_daemons_default_to_the_card(entry, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["-o", str(tmp_path), "-n", "N"] + (["--streams", "x"] if entry is multidaemon_mod else [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.main(argv)


def test_sigkilled_multidaemon_resumes_from_its_last_ack(corpus, runs, tmp_path):
    """A real multidaemon process (--device cpu) SIGKILLed after its first
    checkpoint ack, with a recording in flight and a command sent since; a
    fresh daemon resumes from the state directory and the supervisor
    replays stdin from the acked commands_processed: the kept lines and the
    resumed run's equal the uninterrupted run's events, up to the last
    replayed command's ack. (The kill inside a command, at full size, is
    chip_smoke phase 13's.)"""
    script = multi_script(corpus["wavs"])
    out_dir, state = str(tmp_path / "out"), str(tmp_path / "state")
    os.makedirs(out_dir)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "formula_vad_tpu_torch.apps.multidaemon", "-o", out_dir, "-n", "MULTI",
         "--streams", "a,b", "--denoiser", "demo", "--state", state, "--checkpoint-every", "2", "--device", "cpu"],
        cwd=REPO, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(line.rstrip("\n") for line in proc.stdout), daemon=True)
    reader.start()
    ack = json.dumps({"action": "checkpoint", "commands_processed": 2})
    try:
        proc.stdin.write("".join(line + "\n" for line in script[:2]))
        proc.stdin.flush()
        deadline = time.monotonic() + 60  # a bound on a hang; the ack takes a few seconds
        while ack not in lines:  # the ack of command 2, the first segment
            assert proc.poll() is None, "the daemon exited before its checkpoint ack"
            assert time.monotonic() < deadline, "no checkpoint ack in 60 s"
            time.sleep(0.02)
        proc.stdin.write(script[2] + "\n")  # after the ack: its output is the supervisor's to discard
        proc.stdin.flush()
        time.sleep(0.2)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        reader.join(timeout=30)
        proc.stdin.close()
        proc.stdout.close()
    kept = lines[: lines.index(ack) + 1]  # the supervisor keeps the lines up to the acknowledged save
    buf = io.StringIO()
    md = MultiDaemon("MULTI", out_dir, ["a", "b"], "demo", stdout=buf, state_dir=state, checkpoint_every=2,
                     device="cpu")
    md.run(stdin=io.StringIO("".join(line + "\n" for line in script[2:6])))
    got = [line.replace(out_dir, "OUT") for line in kept] + _lines(buf, out_dir)
    # The uninterrupted run's events up to the ack of command 6, the last replayed.
    ack_6 = runs["multi"].index(json.dumps({"action": "checkpoint", "commands_processed": 6}))
    assert got == runs["multi"][: ack_6 + 1]
