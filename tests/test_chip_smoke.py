"""chip_smoke.py and bench.py: no GPU means a nonzero exit, and the smoke
phases themselves at test parameters on the CPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke
from helm_tpu import params as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(argv, cwd, env=None, timeout=300):
    return subprocess.run(
        [sys.executable, *argv], cwd=cwd, capture_output=True, text=True,
        timeout=timeout, env=env,
    )


def test_main_exits_nonzero_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert "no GPU found" in str(e.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run(["chip_smoke.py"], cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no helm_tpu package" in res.stderr


def test_bench_exits_nonzero_without_gpu():
    res = _run(["bench.py"], cwd=REPO)
    assert res.returncode != 0
    assert "no GPU found" in res.stderr
    assert res.stdout == ""


@pytest.fixture(scope="module")
def smoke_keys(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("keys"))
    sets = [P.TEST_PARAMS, P.TEST_PARAMS_LUT, P.TEST_PARAMS_ARITH,
            P.TEST_PARAMS_ARITH_MB]
    return d, chip_smoke.make_keys(d, sets, seed=3)


@pytest.mark.parametrize(
    "p,lut,G",
    [(P.TEST_PARAMS, False, 8), (P.TEST_PARAMS_LUT, True, 5),
     (P.TEST_PARAMS_ARITH_MB, True, 3)],
    ids=["gates", "lut", "arith-mb2"],
)
def test_phase_pbs(smoke_keys, p, lut, G):
    _, keys = smoke_keys
    res = chip_smoke.phase_pbs(
        p, keys[p.name], G=G, cpu_rows=2, seed=1, lut=lut, windows=2,
        window_s=0.01,
    )
    assert res["G"] == G and len(res["windows"]) == 2
    assert res["bootstraps_per_s"] > 0


@pytest.mark.parametrize(
    "config", chip_smoke.GOLDEN, ids=[c[0] for c in chip_smoke.GOLDEN]
)
def test_phase_cli_golden(smoke_keys, tmp_path, config):
    keys_dir, _ = smoke_keys
    times = chip_smoke.phase_cli(
        keys_dir, str(tmp_path), extra=["--test-params"], configs=[config]
    )
    assert list(times) == [config[0]]


def test_phase_cli_catches_a_wrong_output(smoke_keys, tmp_path):
    """A golden file that disagrees with the evaluation fails the phase."""
    from helm_tpu.io import csv_io

    keys_dir, _ = smoke_keys
    name, args, goldens, typ = chip_smoke.GOLDEN[0]
    flipped = {w: not v for w, v in csv_io.read_input_wires(goldens[0], typ).items()}
    bad = tmp_path / "bad.csv"
    csv_io.write_output_wires(str(bad), flipped)
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.phase_cli(keys_dir, str(tmp_path), extra=["--test-params"],
                             configs=[(name, args, [str(bad)], typ)])


def test_aes_ct_hex(tmp_path):
    ct = bytes.fromhex(chip_smoke.AES_CT)
    f = tmp_path / "ct.csv"
    f.write_text("wire, value\n" + "".join(
        f"ct[{8 * j + i}], {(ct[j] >> i) & 1}\n"
        for j in range(16) for i in range(8)
    ))
    assert chip_smoke.aes_ct_hex(str(f)) == chip_smoke.AES_CT


def test_phase_serve(smoke_keys, tmp_path):
    keys_dir, _ = smoke_keys
    res = chip_smoke.phase_serve(
        keys_dir, str(tmp_path), seed=4, n=4, batch=2,
        extra=["--test-params"],
    )
    assert res["s_per_vector_warm"] >= 0


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_card):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    res = _run(["chip_smoke.py"], cwd=REPO, env=env, timeout=1500)
    assert res.returncode == 0, res.stderr[-3000:]
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
