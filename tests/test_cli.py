"""CLI driver: flag parsing and end-to-end output format."""

import subprocess
import sys

import numpy as np
import pytest

from mdbench_tpu.cli import parse_args


def test_parse_args_reference_flags():
    p = parse_args(
        "-f lj -n 50 -nx 4 -ny 5 -nz 6 -half 1 -r 3.0 -s 0.4 --freq 3.0".split()
    )
    assert p.force_field == 0
    assert p.ntimes == 50
    assert (p.nx, p.ny, p.nz) == (4, 5, 6)
    assert p.half_neigh == 1
    assert p.cutforce == 3.0
    assert p.skin == 0.4
    assert p.cutneigh == 3.4
    assert p.proc_freq == 3.0


def test_parse_args_tpu_axes():
    p = parse_args("--scheme cluster --precision sp --kernel ilist_pl".split())
    assert p.scheme == "cluster"
    assert p.precision == "sp"
    assert p.kernel == "ilist_pl"


@pytest.mark.slow
def test_cli_end_to_end_output_block():
    env_code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import sys; from mdbench_tpu.cli import main;"
        "sys.exit(main(['-nx','3','-ny','3','-nz','3','-n','10',"
        "'--precision','sp']))"
    )
    res = subprocess.run(
        [sys.executable, "-c", env_code],
        capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr
    out = res.stdout
    assert "Parameters:" in out
    assert "step\ttemp\t\tpressure" in out
    assert "System: 108 atoms" in out
    assert "million atom updates per second" in out
    assert "TOTAL" in out and "FORCE" in out and "NEIGH" in out
    # thermo row for step 0 must show the target temperature
    row0 = [l for l in out.splitlines() if l.startswith("0\t")][0]
    assert abs(float(row0.split("\t")[1]) - 1.44) < 1e-5


@pytest.mark.slow
def test_cli_trace_per_reneighbor_cadence(tmp_path):
    """TRACER_CONDITION analogue (reference tracing.h:20-22 +
    main.c:269): with --trace-index, the cli dumps the fresh lists at
    EVERY reneighbor boundary, not just step 0."""
    import os

    prefix = str(tmp_path / "t_")
    conf = tmp_path / "re5.conf"
    conf.write_text("reneigh_every 5\n")
    env_code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import sys; from mdbench_tpu.cli import main;"
        "sys.exit(main(['-p','%s','-nx','3','-ny','3','-nz','3',"
        "'-n','15','--trace-index','%s']))" % (conf, prefix)
    )
    res = subprocess.run(
        [sys.executable, "-c", env_code],
        capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr
    dumps = sorted(
        f for f in os.listdir(tmp_path) if f.startswith("t_")
    )
    # boundaries: 0 (initial), 5, 10, 15
    assert dumps == [
        "t_index_tracer_0.out", "t_index_tracer_10.out",
        "t_index_tracer_15.out", "t_index_tracer_5.out",
    ], dumps


@pytest.mark.slow
def test_cli_timers_diff_mode():
    """--timers diff: in-loop differential FORCE/NEIGH (extra chained
    force pass / halved reneighbor interval, differenced totals)."""
    env_code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import sys; from mdbench_tpu.cli import main;"
        "sys.exit(main(['-nx','3','-ny','3','-nz','3','-n','10',"
        "'--timers','diff']))"
    )
    res = subprocess.run(
        [sys.executable, "-c", env_code],
        capture_output=True, text=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr
    assert "FORCE" in res.stdout and "NEIGH" in res.stdout


@pytest.mark.slow
def test_cli_checkpoint_restore_roundtrip(tmp_path):
    """--checkpoint writes the final state; --restore resumes from it.
    A 10-step run checkpointed then restored for 10 more steps must end
    at the same thermo as one uninterrupted 20-step run (restored
    states are never thermo-re-adjusted)."""
    ck = str(tmp_path / "state.npz")
    base = "'-nx','3','-ny','3','-nz','3','--precision','sp'"
    run = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "import sys; from mdbench_tpu.cli import main;"
        "sys.exit(main([{}]))"
    )
    r1 = subprocess.run(
        [sys.executable, "-c",
         run.format(base + ",'-n','10','--checkpoint','%s'" % ck)],
        capture_output=True, text=True, timeout=600,
    )
    assert r1.returncode == 0, r1.stderr
    assert "checkpoint ->" in r1.stdout
    r2 = subprocess.run(
        [sys.executable, "-c",
         run.format(base + ",'-n','10','--restore','%s'" % ck)],
        capture_output=True, text=True, timeout=600,
    )
    assert r2.returncode == 0, r2.stderr
    assert "restored 108 atoms at step 10" in r2.stdout
    r3 = subprocess.run(
        [sys.executable, "-c", run.format(base + ",'-n','20'")],
        capture_output=True, text=True, timeout=600,
    )
    assert r3.returncode == 0, r3.stderr

    def final_temp(out):
        rows = [l for l in out.splitlines()
                if l and l[0].isdigit() and "\t" in l]
        return float(rows[-1].split("\t")[1])

    assert abs(final_temp(r2.stdout) - final_temp(r3.stdout)) < 1e-6
