"""CLI driver tests — the reference main.cpp contract (SURVEY.md §4):
load, warmup+timed runs, verify vs golden, print metrics."""
import json

import pytest

from benchmark_spgemm_using_csr_tpu.cli import main, load_matrix


def test_cli_suite_matrix_json(capsys):
    rc = main(
        ["suite:poisson2d_64", "--runs", "1", "--warmup", "1", "--json"]
    )
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["verified"] is True
    assert rec["nnz_c"] > 0
    assert rec["gflops"] > 0


def test_cli_text_output(capsys):
    rc = main(["gen:er:256", "--runs", "1", "--warmup", "0", "--method", "esc"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "GFlops" in out and "PASS" in out


def test_cli_hash_method(capsys):
    rc = main(
        ["gen:powerlaw:256", "--runs", "1", "--warmup", "0", "--method", "hash", "--json"]
    )
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["verified"] is True


def test_cli_mtx_roundtrip(tmp_path, capsys):
    from benchmark_spgemm_using_csr_tpu.utils import generators
    from benchmark_spgemm_using_csr_tpu.utils.mtx import write_mtx

    p = tmp_path / "m.mtx"
    write_mtx(str(p), generators.poisson2d(16))
    rc = main([str(p), "--runs", "1", "--warmup", "0", "--json"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["m"] == 256 and rec["verified"] is True


def test_cli_distributed_mesh(capsys):
    rc = main(
        ["gen:er:128", "--runs", "1", "--warmup", "0", "--mesh", "4",
         "--schedule", "ring", "--json"]
    )
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["verified"] is True


def test_cli_roofline(capsys):
    rc = main(["gen:er:128", "--runs", "1", "--warmup", "0", "--roofline", "--json"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "sol_time_s" in out


def test_load_matrix_unknown_suite():
    with pytest.raises(SystemExit):
        load_matrix("suite:nope", None)


def test_cli_mesh_too_large_raises():
    # 8 virtual devices: a 16-device mesh must fail, not fall back
    with pytest.raises(SystemExit, match="needs 16"):
        main(["gen:er:128", "--runs", "1", "--warmup", "0", "--mesh", "16"])
