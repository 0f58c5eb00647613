"""chip_smoke.py: its phases rehearsed at small widths on the CPU.

The script's phases take their widths from ``Sizes``; here they run at a
tiny size with interpreted kernels, which checks the paths, arguments and
control flow the card run depends on. The ``gpu``-marked tests run the
phases at full width and skip off the card.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

TINY = cs.Sizes(
    gpt2="tiny",
    flash_cases=(("a", 1, 64, 2, 2, 32), ("b", 1, 64, 4, 2, 64)),
    cross=(32, 80),
    t5_seq=64,
    t5_heads=2,
    paged=(2, 64, 2, 4, 32, 16),
    serve_lengths=(5, 17, 30, 40),
    serve_new=3,
    page=16,
    chunk=32,
    train_batch=2,
    train_seq=32,
    train_steps=2,
    ring=(1, 256, 4, 32),
)


@pytest.mark.parametrize("phase", ["kernels", "serving", "training", "four_cards"])
def test_phase_rehearsal(phase, capsys):
    getattr(cs, f"phase_{phase}")(TINY)
    out = capsys.readouterr().out
    assert "FAIL" not in out
    assert " ok" in out or "token-identical" in out or "loss=" in out


def test_check_raises_past_tolerance(capsys):
    cs.check("inside", 1e-3, 1e-2)
    with pytest.raises(cs.CheckFailed):
        cs.check("outside", 2e-2, 1e-2)
    assert "FAIL" in capsys.readouterr().out


def test_refuses_to_run_without_a_gpu():
    """Off the card the script exits non-zero and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_fails_without_the_program(tmp_path):
    """Alone in a directory, the script cannot import the program."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_full_widths_are_the_issue_shapes():
    assert cs.FULL.gpt2 == "medium"
    assert ("gpt2-medium", 8, 1024, 16, 16, 64) in cs.FULL.flash_cases
    assert ("llama-gqa", 2, 4096, 32, 8, 128) in cs.FULL.flash_cases
    assert cs.FULL.paged == (16, 4096, 8, 32, 128, 64)
    assert (min(cs.FULL.serve_lengths), max(cs.FULL.serve_lengths)) == (17, 700)
    assert len(cs.FULL.serve_lengths) == 8 and cs.FULL.serve_new == 32
    assert (cs.FULL.train_batch, cs.FULL.train_seq, cs.FULL.train_steps) == (8, 1024, 3)
    assert cs.FULL.ring == (1, 32768, 16, 64)


@pytest.mark.gpu
@pytest.mark.parametrize("phase", ["kernels", "serving", "training"])
def test_phase_on_card(phase, gpu_device):
    getattr(cs, f"phase_{phase}")(cs.FULL)


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_returns_nonzero_on_cpu(argv, capsys):
    assert cs.main(argv) == 1
    out = capsys.readouterr().out
    assert out.startswith("phase device: platform=cpu")
    for line in out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
