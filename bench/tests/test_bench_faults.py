"""The check must fail a broken timed path: each tiny twin cell runs end to
end on the CPU with a fault of ``bench/tools/faults.py`` planted in the
program underneath, and ``correct`` comes out false.  The control, the
float64 reference in the program's place, fails too."""
import pytest

from benchlib import cli, spec
from tools.faults import FAULTS

CKKS = ["tiny-keyswitch", "tiny-matvec"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CKKS + ["tiny-ntt"])
def test_a_planted_fault_fails_the_check(tiny_checkout, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch.setattr)
    r = cli.run_cell(spec.load(cell, tiny_checkout), 977, 0.3, False, "cpu", 0.0)
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("cell", CKKS + ["tiny-ntt"])
def test_the_control_fails_the_check(tiny_checkout, cell):
    c = spec.load(cell, tiny_checkout)
    run = spec.system(c.config["system"]).Run(c, 31, "cpu")
    run.keep_without_program(1.0, 40 if cell == "tiny-ntt" else 2)
    compared = run.check(control=True)
    assert compared["mismatched_words"][0] > 0
    assert not all(v <= lim for v, lim in compared.values())
