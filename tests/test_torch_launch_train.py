"""The port's training launcher (``launch/train.py``) on the CPU:
``main([... "--smoke", "--device", "cpu", ...])`` trains and prints the
reference launcher's last line, a second call with more steps resumes
from its checkpoint, and ``--mesh pod1`` / ``pod2`` refuse to run."""
import re

import pytest
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.launch import train

torch.set_num_threads(2)

LAST_LINE = re.compile(r"^\[train\] (\S+): loss (\d+\.\d{4}) -> (\d+\.\d{4}) "
                       r"\((\d+) steps, (\d+) device\(s\)\)$")


def args(tmp_path, steps, *extra):
    return ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", str(steps),
            "--seq", "16", "--batch", "2", "--ckpt-every", "2", "--remat", "none",
            "--ckpt-dir", str(tmp_path), *extra]


def last_line(capsys):
    return capsys.readouterr().out.strip().splitlines()[-1]


def test_main_prints_the_reference_line_and_resumes(tmp_path, capsys):
    losses = train.main(args(tmp_path, 4))
    m = LAST_LINE.match(last_line(capsys))
    assert m, last_line(capsys)
    assert m.group(1) == "smollm-135m" and m.group(4) == "4" and m.group(5) == "1"
    assert float(m.group(2)) == round(losses[0], 4) and len(losses) == 4
    assert ckpt.list_steps(str(tmp_path)) == [2, 4]

    more = train.main(args(tmp_path, 6))
    out = capsys.readouterr().out
    assert "[loop] resumed from step 4" in out
    assert len(more) == 2
    assert LAST_LINE.match(out.strip().splitlines()[-1])
    assert ckpt.list_steps(str(tmp_path)) == [2, 4, 6]


@pytest.mark.parametrize("remat,compression,mb", [("full", "int8_ef", 2), ("dots", "bf16", 1)])
def test_main_options(tmp_path, capsys, remat, compression, mb):
    # the last --remat on the line wins
    train.main(args(tmp_path, 2, "--microbatches", str(mb), "--grad-compression",
                    compression, "--schedule", "cosine", "--remat", remat))
    assert LAST_LINE.match(last_line(capsys))


@pytest.mark.parametrize("mesh", ["pod1", "pod2"])
def test_mesh_raises(tmp_path, mesh):
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        train.main(args(tmp_path, 2, "--mesh", mesh))
