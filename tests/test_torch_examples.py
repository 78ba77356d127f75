"""The four example twins (``examples/*_torch.py``) run as a reader runs
them, with ``--device cpu``, beside their JAX examples.

Each twin's printed lines, with every number masked (and runs of spaces,
which pad numbers to a width, taken as one), equal its JAX example's at
the same flags (the gas twin at ``--steps 20 --hidden 16``,
run in the same test; the checkpoint directory's random name masked too).
The digits example takes no flags and trains 400 steps, so the digits
twin (``--steps 20``) is held to the labels its JAX example's source
prints, in order. Each twin also holds the invariants ``chip_smoke.py``
phase 5j holds on the card: the quickstart's theta=0 line within 1e-4 (the
delta memory sums rounded deltas; the JAX example prints ~2e-7 there too)
and its state-safety error; the decode twin's theta=0 row at drift 0.0000
and a 100 % token match; the training twins' losses finite and falling.
The file takes ~85 s on one CPU worker.
"""
import ast
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]\d+)?")


def _run(name: str, *argv: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                           *argv], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, \
        f"{name} exited {proc.returncode}\n{proc.stdout[-2000:]}\n" \
        f"{proc.stderr[-2000:]}"
    return proc.stdout


def _masked(out: str) -> list:
    out = re.sub(r"gas_ckpt_\w+", "gas_ckpt_", out)
    return [" ".join(NUMBER.sub("#", line).split())
            for line in out.splitlines()]


def _line(out: str, label: str) -> str:
    return next(ln for ln in out.splitlines() if ln.startswith(label))


def _numbers(line: str) -> list:
    return [float(x) for x in NUMBER.findall(line)]


@pytest.mark.parametrize("name,argv", [
    ("quickstart", ()),
    ("train_gas_regression", ("--steps", "20", "--hidden", "16")),
    ("lm_delta_decode", ())])
def test_twin_prints_its_examples_lines(name, argv):
    twin = _run(f"{name}_torch.py", "--device", "cpu", *argv)
    ref = _run(f"{name}.py", *argv)
    assert _masked(twin) == _masked(ref)
    if name == "quickstart":
        assert _numbers(_line(twin, "theta=0   max"))[1] <= 1e-4
        assert _line(twin, "state safety: ").endswith("...")
    elif name == "lm_delta_decode":
        row = _line(twin, "   0.000 ").split()
        assert row[4] == "0.0000" and row[5] == "100%"
    else:
        first, last = _numbers(_line(twin, "stage 1"))[1:]
        final = _numbers(_line(twin, "stage 2"))[1]
        assert all(map(math.isfinite, (first, last, final)))
        assert last < first and final < first


def _printed_labels(source: Path) -> list:
    """The literal text each ``print`` of a script starts with, in order
    (up to its first placeholder, blank lines dropped)."""
    labels = []
    for node in ast.walk(ast.parse(source.read_text())):
        if not (isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "print" and node.args):
            continue
        arg = node.args[0]
        parts = arg.values if isinstance(arg, ast.JoinedStr) else [arg]
        text = ""
        for part in parts:
            if not isinstance(part, ast.Constant):
                break
            text += part.value
        text = text.lstrip("\n")
        if text:
            labels.append((node.lineno, text))
    return [t for _, t in sorted(labels)]


def test_digits_twin_prints_its_examples_labels():
    out = _run("serve_stream_digits_torch.py", "--device", "cpu", "--steps",
               "20")
    labels = _printed_labels(ROOT / "examples" / "serve_stream_digits.py")
    assert len(labels) == 11
    lines = out.splitlines()
    at = 0
    for label in labels:
        while at < len(lines) and not lines[at].startswith(label):
            at += 1
        assert at < len(lines), f"no line {label!r} in order:\n{out}"
        at += 1
    first, last = _numbers(_line(out, "trained digit recognizer"))
    assert math.isfinite(first) and math.isfinite(last) and last < first


@pytest.mark.parametrize("name", ["quickstart", "serve_stream_digits",
                                  "train_gas_regression", "lm_delta_decode"])
def test_twin_without_a_card_raises(name):
    """The twins run on the card by default: without one they raise and
    print no result."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable,
                           str(ROOT / "examples" / f"{name}_torch.py")],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=ROOT)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
