"""The port's serving entry points on the CPU: ``python -m
repro_torch.launch.serve`` and ``repro_torch.launch.server`` (the
real-socket ``--selftest``), the flags they refuse, and that they run on
CUDA unless the CPU is named."""

import json

import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.launch import serve, server


def test_serve_main_on_cpu_prints_its_metrics(capsys, tmp_path):
    out = tmp_path / "metrics.json"
    report = serve.main(["--device", "cpu", "--preset", "tiny",
                         "--requests", "6", "--max-new", "4",
                         "--json", str(out)])
    printed = capsys.readouterr().out
    for key in ("served", "decode_tokens_per_s", "bucket_compiles",
                "page_hwm", "failed_requests"):
        assert f"{key}:" in printed
    assert report["device"] == "cpu"
    assert report["served"] == 6 and report["aborted"] == 0
    assert report["bucket_compiles"] <= report["bucket_budget"]
    assert json.loads(out.read_text()) == report


def test_serve_keeps_the_reference_presets_and_workload():
    assert serve.PRESETS == jserve.PRESETS
    assert serve.synthetic_workload(9, 97) == \
        jserve.synthetic_workload(9, 97)


def test_serve_faults_flag_fails_one_request(capsys):
    report = serve.main(["--device", "cpu", "--requests", "4",
                         "--max-new", "4", "--faults", "nan_logits@3"])
    assert report["failed_requests"] == 1
    assert report["served"] == 3
    assert "[failed]" in capsys.readouterr().out


def test_server_selftest_two_streams_on_cpu(capsys):
    with pytest.raises(SystemExit) as ei:
        server.main(["--device", "cpu", "--selftest", "2"])
    assert ei.value.code == 0
    assert "[selftest] 2/2 streams finished" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--tp", "2"]])
def test_sharded_flags_raise(flags, capsys):
    """``--dp``/``--tp`` serve on a mesh of ranks the command starts
    itself (gloo on the CPU), with rank 0's report printed; only a count
    below 1 still raises."""
    argv = ["--device", "cpu", "--requests", "6", "--max-new", "4", *flags]
    report = serve.main(argv)
    assert report["served"] == 6 and report["aborted"] == 0
    assert report["n_replicas"] == (2 if flags[0] == "--dp" else 1)
    assert report["tp"] == (2 if flags[0] == "--tp" else 1)
    assert "served:" in capsys.readouterr().out
    with pytest.raises(ValueError):
        serve.main(["--device", "cpu", flags[0], "0"])


def test_entry_points_need_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.main(["--selftest", "1"])
