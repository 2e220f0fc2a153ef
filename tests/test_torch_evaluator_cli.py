"""The port's ``vad-evaluator`` executable (``apps/evaluator_cli.py``, a
copy of the JAX package's; mirrors tests/test_apps.py's TestEvaluatorCli)."""

from formula_vad_tpu_torch.apps import evaluator_cli


def test_cli(tmp_path, capsys):
    vad_txt = tmp_path / "vad.txt"
    ref_txt = tmp_path / "ref.txt"
    vad_txt.write_text("1.0\t3.0\tx\n")
    ref_txt.write_text("1.0\t3.0\tspeech\n")
    assert evaluator_cli.main(["-i", str(vad_txt), "-r", str(ref_txt)]) == 0
    out = capsys.readouterr().out
    assert "True positive rate   (TPR):  100.00 %" in out


def test_cli_against_the_jax_package(tmp_path, capsys):
    """The same report as the JAX package's executable, on a partial match."""
    from formula_vad_tpu.apps import evaluator_cli as jax_evaluator_cli

    (tmp_path / "vad.txt").write_text("1.0\t3.0\tx\n5.0\t5.5\ty\n9.0\t12.0\tz\n")
    (tmp_path / "ref.txt").write_text("1.5\t3.5\tspeech\n10.0\t11.0\tspeech\n20.0\t22.0\tspeech\n")
    argv = ["-i", str(tmp_path / "vad.txt"), "-r", str(tmp_path / "ref.txt")]
    outs = []
    for main in (evaluator_cli.main, jax_evaluator_cli.main):
        assert main(argv) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "%" in outs[0]
